"""The port's sidecar daemon (tmtpu_torch/sidecar/) on the CPU, driven by
the reference's own, unmodified client (tmtpu/sidecar/client.py) and by a
tmtpu node's flush with ``crypto_backend=sidecar``: the reference's
scenarios (tests/test_sidecar.py, tests/test_sidecar_protocol.py) and new
ones, with masks, tallies, statuses and dispatch metadata held against the
reference daemon (``backend="cpu"``) on the same lanes. Also the port's own
client against the reference daemon, and ``python -m tmtpu_torch sidecar``
in a process of its own.

The port daemon runs the plain PyTorch versions here, seconds a dispatch
whatever its width, so requests stay at a few lanes; every socket wait has
a timeout."""

import contextlib
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest

from tests.test_torch_mixed import mixed_items
from tmtpu.config.config import SidecarConfig
from tmtpu.crypto import batch as jbatch
from tmtpu.crypto import ed25519 as jed
from tmtpu.libs import breaker as _bk
from tmtpu.libs import metrics as _m
from tmtpu.sidecar import protocol as ref_proto
from tmtpu.sidecar.client import SidecarClient, SidecarOverloaded, SidecarUnavailable
from tmtpu.sidecar.server import SidecarServer as RefServer
from tmtpu_torch.crypto import batch, sigcache
from tmtpu_torch.sidecar import client as port_client
from tmtpu_torch.sidecar import protocol as proto
from tmtpu_torch.sidecar.server import SidecarServer, trace_ctx_valid

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 120.0  # a plain-version dispatch takes seconds on a loaded CPU


@pytest.fixture(autouse=True)
def _fresh_port_sigcache():
    """The port's cache is process-wide: every test starts on an empty,
    enabled one (tests/conftest.py does the same for the reference's)."""
    sigcache.DEFAULT.set_enabled(True)
    sigcache.DEFAULT.invalidate_all()
    yield
    sigcache.DEFAULT.set_enabled(True)
    sigcache.DEFAULT.invalidate_all()


def _lanes(n, bad=(), tag=b"sc", power=1000):
    """n raw (pk_bytes, msg, sig, power) ed25519 lanes; indices in ``bad``
    get a corrupted signature (as tests/test_sidecar.py builds them)."""
    out = []
    for i in range(n):
        priv = jed.gen_priv_key_from_secret(b"%s-%d" % (tag, i))
        msg = b"%s msg %d" % (tag, i)
        sig = priv.sign(msg)
        if i in bad:
            sig = bytes([sig[0] ^ 0xFF]) + sig[1:]
        out.append((priv.pub_key().bytes(), msg, sig, power))
    return out


@contextlib.contextmanager
def _daemon(kind, path, **kw):
    """A started daemon on a unix socket: the port's on the CPU, or the
    reference's with its CPU backend."""
    addr = f"unix://{path}/{kind}.sock"
    srv = (SidecarServer(addr, device="cpu", **kw) if kind == "port"
           else RefServer(addr, backend="cpu", **kw))
    srv.start()
    try:
        yield srv
    finally:
        srv.stop()


@contextlib.contextmanager
def _client(srv, name):
    c = SidecarClient(srv.addr, client_id=name, request_deadline_s=DEADLINE_S,
                      connect_timeout_s=10.0)
    try:
        yield c
    finally:
        c.close()


def _fix_window(srv, seconds):
    srv.coalescer.scheduler.gather_wait_s = lambda pending: seconds


def _both(tmp_path, scenario, **kw):
    """Run ``scenario(server)`` on the reference daemon and on the port's;
    both results must be equal. Returns the port's."""
    results = {}
    for kind in ("ref", "port"):
        with _daemon(kind, tmp_path, **kw) as srv:
            results[kind] = scenario(srv)
    assert results["port"] == results["ref"]
    return results["port"]


def _concurrent(srv, requests):
    """Send {client name: (curve, lanes, tally)} from one client each at
    once; returns {name: (mask, tallied, info)} or the exception's type
    name and status text."""
    out = {}
    barrier = threading.Barrier(len(requests))

    def run(name, curve, lanes, tally):
        with _client(srv, name) as c:
            barrier.wait(timeout=30)
            try:
                out[name] = c.verify(curve, lanes, tally=tally)
            except (SidecarUnavailable, SidecarOverloaded) as exc:
                out[name] = (type(exc).__name__, str(exc).split(":")[0])

    ts = [threading.Thread(target=run, args=(name, *req)) for name, req in requests.items()]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=2 * DEADLINE_S)
    assert set(out) == set(requests)
    return out


# --- the reference's scenarios --------------------------------------------------


def test_verify_and_tally_exact_mask(tmp_path):
    def scenario(srv):
        with _client(srv, "t1") as c:
            first = c.verify("ed25519", _lanes(6, bad={2, 5}), tally=True)
            second = c.verify("ed25519", _lanes(3, tag=b"vo"))  # verify only
        return first, second

    (mask, tallied, info), (mask2, tallied2, info2) = _both(tmp_path, scenario)
    assert mask == [True, True, False, True, True, False] and tallied == 4000
    assert info == {"dispatch_id": 1, "dispatch_lanes": 6, "dispatch_clients": 1,
                    "dispatch_traces": 0}
    assert mask2 == [True] * 3 and tallied2 == 0 and info2["dispatch_id"] == 2


def test_bad_requests_rejected(tmp_path):
    def scenario(srv):
        out = []
        with _client(srv, "t2") as c:
            for curve, lanes in (("curve448", _lanes(1)), ("ed25519", [])):
                with pytest.raises(SidecarUnavailable) as err:
                    c.verify(curve, lanes)
                out.append(str(err.value))
            out.append(c.verify("ed25519", _lanes(2))[0])  # the connection survives
        return out

    got = _both(tmp_path, scenario)
    assert got[0] == "sidecar status bad_request: unknown curve 'curve448'"
    assert got[1] == "sidecar status bad_request: zero lanes"
    assert got[2] == [True, True]


def test_two_clients_coalesce_into_one_dispatch(tmp_path):
    """Two concurrent clients' lanes land in one joint dispatch, and each
    gets exactly the mask slice and the tally of its own lanes."""
    def scenario(srv):
        _fix_window(srv, 0.5)
        return _concurrent(srv, {
            "a": ("ed25519", _lanes(5, bad={1}, tag=b"client-a"), True),
            "b": ("ed25519", _lanes(7, bad={2, 3}, tag=b"client-b"), True)})

    got = _both(tmp_path, scenario)
    mask_a, tallied_a, info_a = got["a"]
    mask_b, tallied_b, info_b = got["b"]
    assert mask_a == [True, False, True, True, True] and tallied_a == 4000
    assert mask_b == [True, True, False, False, True, True, True] and tallied_b == 5000
    assert info_a == info_b == {"dispatch_id": 1, "dispatch_lanes": 12,
                                "dispatch_clients": 2, "dispatch_traces": 0}


def test_overload_reply_and_recovery(tmp_path):
    """A full queue answers OVERLOADED at once, and the queued request still
    completes."""
    def scenario(srv):
        _fix_window(srv, 30.0)  # park arrivals so the queue can fill
        with _client(srv, "full-1") as c1, _client(srv, "full-2") as c2:
            first = {}
            t = threading.Thread(target=lambda: first.update(r=c1.verify("ed25519", _lanes(3))))
            t.start()
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline and srv.coalescer.queued_lanes() < 3:
                time.sleep(0.02)
            assert srv.coalescer.queued_lanes() == 3
            with pytest.raises(SidecarOverloaded):
                c2.verify("ed25519", _lanes(3, tag=b"ovl"))
            _fix_window(srv, 0.0)  # the next arrival re-evaluates the window
            nudge = c2.verify("ed25519", _lanes(1, tag=b"nudge"))
            t.join(timeout=2 * DEADLINE_S)
            return first["r"], nudge

    (mask, _, _), (nudge, _, _) = _both(tmp_path, scenario, max_queue_lanes=4)
    assert mask == [True] * 3 and nudge == [True]


def test_oversized_request_rejected(tmp_path):
    def scenario(srv):
        with _client(srv, "big") as c:
            with pytest.raises(SidecarOverloaded) as err:
                c.verify("ed25519", _lanes(5))
            return str(err.value)

    assert _both(tmp_path, scenario, max_lanes_per_dispatch=4) == \
        "5 lanes exceeds per-request cap 4"


def test_stats_and_ping(tmp_path):
    with _daemon("port", tmp_path) as srv, _client(srv, "introspect") as c:
        pong = c.ping()
        assert pong.backend == "cpu" and c.hello_ack.backend == "cpu"
        assert c.hello_ack.version == ref_proto.PROTOCOL_VERSION
        before = c.stats()["sigcache"]  # lifetime counters
        c.verify("ed25519", _lanes(2))
        stats = c.stats()
        assert stats["server_id"] == srv.server_id and stats["backend"] == "cpu"
        assert stats["coalescer"]["dispatches"] == 1 and stats["connections"] >= 1
        assert stats["coalescer"]["scheduler"]["enabled"] is True
        assert stats["sigcache"]["misses"] - before["misses"] == 2
        assert stats["sigcache"]["inserts"] - before["inserts"] == 2
        assert stats["engine"]["last_cache_stats"] == {"lanes": 2, "hits": 0, "dedup": 0,
                                                       "dispatched": 2}


def _connect_raw(addr):
    _, path = proto.parse_addr(addr)
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(10.0)
    s.connect(path)
    return s


@pytest.mark.parametrize("kind", ["ref", "port"])
def test_handshake_rejections(tmp_path, kind):
    """A Hello of an unsupported version gets ERR_VERSION and a closed
    connection, a version-1 Hello is served at version 1, a non-Hello
    first message and a garbage first frame get ERR_PROTOCOL; the same
    from both daemons."""
    with _daemon(kind, tmp_path) as srv:
        s = _connect_raw(srv.addr)
        proto.write_frame(s.makefile("wb"), proto.Hello(version=3, client_id="time-traveler"))
        rd = proto.FrameReader(s.makefile("rb"))
        reply = rd.read_msg()
        assert isinstance(reply, proto.ErrorReply) and reply.code == proto.ERR_VERSION
        with pytest.raises(EOFError):  # the daemon closed the connection
            rd.read_msg()
        s.close()

        s = _connect_raw(srv.addr)
        proto.write_frame(s.makefile("wb"), proto.Hello(version=1, client_id="old"))
        ack = proto.FrameReader(s.makefile("rb")).read_msg()
        assert isinstance(ack, proto.HelloAck) and ack.version == 1 and ack.max_lanes > 0
        assert ack.backend == "cpu"
        s.close()

        s = _connect_raw(srv.addr)
        proto.write_frame(s.makefile("wb"), proto.Ping(nonce=1))
        reply = proto.FrameReader(s.makefile("rb")).read_msg()
        assert isinstance(reply, proto.ErrorReply) and reply.code == proto.ERR_PROTOCOL
        s.close()

        s = _connect_raw(srv.addr)
        s.sendall(proto.encode_uvarint(3) + b"\xee\x01\x02")
        reply = proto.FrameReader(s.makefile("rb")).read_msg()
        assert isinstance(reply, proto.ErrorReply) and reply.code == proto.ERR_PROTOCOL
        s.close()


def test_malformed_verify_request_after_handshake(tmp_path):
    """A truncated VerifyRequest on a live connection gets ERR_PROTOCOL and
    a closed connection from both daemons."""
    def scenario(srv):
        s = _connect_raw(srv.addr)
        proto.write_frame(s.makefile("wb"), proto.Hello(version=2, client_id="x"))
        rd = proto.FrameReader(s.makefile("rb"))
        assert isinstance(rd.read_msg(), proto.HelloAck)
        body = bytes([proto.VERIFY_REQUEST_TYPE]) + b"\x2a\x40\x0a"  # a lane cut short
        s.sendall(proto.encode_uvarint(len(body)) + body)
        reply = rd.read_msg()
        with pytest.raises(EOFError):
            rd.read_msg()
        s.close()
        return type(reply).__name__, reply.code

    assert _both(tmp_path, scenario) == ("ErrorReply", proto.ERR_PROTOCOL)


# --- a tmtpu node's flush routed to the port's daemon ---------------------------


@pytest.fixture
def node_on_port_daemon(tmp_path):
    """The port's daemon wired into tmtpu/crypto/batch.py the way node.py
    does it: configure_sidecar + crypto.backend=sidecar."""
    srv = SidecarServer(f"unix://{tmp_path}/sc.sock", device="cpu")
    srv.start()
    prev_backend = jbatch._default_backend
    cfg = SidecarConfig(addr=srv.addr, breaker_failure_threshold=2,
                        connect_timeout_ns=10_000_000_000,
                        request_deadline_ns=int(DEADLINE_S * 1e9), retry_backoff_ns=0)
    jbatch.configure_sidecar(cfg)
    jbatch.set_default_backend("sidecar")
    br = _bk.get(jbatch.SIDECAR_BREAKER_NAME)
    br.reset()
    fallbacks = sum(_m.sidecar_client_fallback.summary_series().values())
    yield srv
    # nothing fell back in-process: every lane was the port daemon's
    assert sum(_m.sidecar_client_fallback.summary_series().values()) == fallbacks
    srv.stop()
    jbatch.set_default_backend(prev_backend)
    jbatch.configure_sidecar(SidecarConfig())
    jbatch.reset_sidecar_client()
    br.reset()


def _node_flush(items, tally):
    """One flush of (reference key, msg, sig, power) items through the
    node's default verifier and through CPUBatchVerifier on fresh caches."""
    from tmtpu.crypto import sigcache as jsigcache

    results = []
    for make in (jbatch.new_batch_verifier, jbatch.CPUBatchVerifier):
        jsigcache.DEFAULT.invalidate_all()
        bv = make()
        for key, msg, sig, power in items:
            bv.add(key, msg, sig, power)
        results.append(bv.verify_tally() if tally else bv.verify())
    return results


def test_node_flush_routes_to_port_daemon(node_on_port_daemon):
    assert isinstance(jbatch.new_batch_verifier(), jbatch.SidecarBatchVerifier)
    items = [(jed.PubKeyEd25519(pk), msg, sig, power)
             for pk, msg, sig, power in _lanes(5, bad={3}, tag=b"route")]
    got, want = _node_flush(items, tally=True)
    assert got == want == (False, [True, True, True, False, True], 4000)
    assert node_on_port_daemon.coalescer.snapshot()["dispatches"] == 1


def test_node_mixed_curve_flush_on_port_daemon(node_on_port_daemon):
    """ed25519, sr25519 and secp256k1 lanes in one node flush: one request
    a curve, one dispatch each, the reference's mask and tally."""
    items = [(ref_key, msg, sig, power)
             for _, ref_key, msg, sig, power in
             mixed_items([batch.ED25519, batch.SR25519, batch.SECP256K1], n=12, seed=61)]
    got, want = _node_flush(items, tally=True)
    assert got == want
    assert any(want[1]) and not all(want[1])
    snap = node_on_port_daemon.coalescer.snapshot()
    assert snap["dispatches"] == 3 and snap["queued_lanes"] == 0


# --- new cases --------------------------------------------------------------------


def test_cache_hits_across_clients(tmp_path):
    """A triple verified for client A is a hit for client B: B's request
    dispatches no lane, and gets the same mask and tally."""
    with _daemon("port", tmp_path) as srv:
        lanes = _lanes(4, bad={1}, tag=b"shared")
        with _client(srv, "node-a") as a:
            got_a = a.verify("ed25519", lanes, tally=True)
        before = srv.snapshot()["sigcache"]
        with _client(srv, "node-b") as b:
            got_b = b.verify("ed25519", lanes, tally=True)
        after = srv.snapshot()
    assert got_a[:2] == got_b[:2] == ([True, False, True, True], 3000)
    assert after["engine"]["last_cache_stats"] == {"lanes": 4, "hits": 3, "dedup": 0,
                                                   "dispatched": 1}
    assert after["sigcache"]["hits"] - before["hits"] == 3


def test_identical_lanes_of_two_clients_share_lanes(tmp_path):
    """Two validators' processes sending the same lanes in one dispatch:
    the joint flush dedups them onto one lane each, and each client gets
    its exact mask and tally."""
    lanes = _lanes(4, bad={2}, tag=b"dup", power=7)

    def scenario(srv):
        _fix_window(srv, 0.5)
        return _concurrent(srv, {"a": ("ed25519", lanes, True), "b": ("ed25519", lanes, True)})

    with _daemon("port", tmp_path) as srv:
        got = scenario(srv)
        stats = srv.snapshot()["engine"]["last_cache_stats"]
    assert got["a"] == got["b"]
    assert got["a"][:2] == ([True, True, False, True], 21)
    assert got["a"][2]["dispatch_lanes"] == 8 and got["a"][2]["dispatch_clients"] == 2
    assert stats == {"lanes": 8, "hits": 0, "dedup": 4, "dispatched": 4}


@pytest.mark.parametrize("fault", ["raises", "short mask"])
def test_engine_failure_answers_backend_down(tmp_path, fault):
    """An engine exception, or a mask of the wrong length, answers the
    request STATUS_BACKEND_DOWN with no mask, as the reference's daemon
    does; the daemon keeps serving."""
    def engine(curve, *cols):
        if fault == "raises":
            raise RuntimeError("device lost")
        return [True], 0

    def scenario(srv):
        real = srv.coalescer._verify_fn
        srv.coalescer._verify_fn = (engine if isinstance(srv, SidecarServer)
                                    else lambda curve, items, tally: engine(curve, items))
        with _client(srv, "f") as c:
            with pytest.raises(SidecarUnavailable) as err:
                c.verify("ed25519", _lanes(3))
            srv.coalescer._verify_fn = real
            return str(err.value), c.verify("ed25519", _lanes(1, tag=b"after"))[0]

    msg, after = _both(tmp_path, scenario)
    assert msg.startswith("sidecar status backend_down: verify engine")
    assert after == [True]


def test_wrong_size_key_fails_the_whole_dispatch(tmp_path):
    """The reference's engine builds a key object from every lane, and a
    key of the wrong size raises there: every request in that joint
    dispatch gets STATUS_BACKEND_DOWN. The port keeps that behaviour."""
    bad = _lanes(1, tag=b"short")
    bad = [(bad[0][0][:31],) + bad[0][1:]]

    def scenario(srv):
        _fix_window(srv, 0.5)
        return _concurrent(srv, {"good": ("ed25519", _lanes(3, tag=b"good"), True),
                                 "short": ("ed25519", bad, True)})

    got = _both(tmp_path, scenario)
    assert got == {"good": ("SidecarUnavailable", "sidecar status backend_down"),
                   "short": ("SidecarUnavailable", "sidecar status backend_down")}


def test_pipelined_requests_and_trace_contexts(tmp_path):
    """Two requests pipelined on one connection ride one dispatch; a valid
    v2 trace context is counted in dispatch_traces, a garbage one is not,
    and neither is rejected."""
    good_ctx = bytes([1]) + bytes(range(8)) + (5).to_bytes(8, "big") + bytes([1, 4]) + b"node"
    assert trace_ctx_valid(good_ctx) and not trace_ctx_valid(b"\x01garbage")
    lanes = _lanes(2, bad={1}, tag=b"traced")
    cols = [list(c) for c in zip(*lanes)]
    with _daemon("port", tmp_path) as srv:
        _fix_window(srv, 0.5)
        s = _connect_raw(srv.addr)
        s.settimeout(DEADLINE_S)
        proto.write_frame(s.makefile("wb"), proto.Hello(version=2, client_id="p"))
        rd = proto.FrameReader(s.makefile("rb"))
        assert isinstance(rd.read_msg(), proto.HelloAck)
        s.sendall(proto.encode_verify_frame(1, "ed25519", True, 0, *cols, trace_ctx=good_ctx)
                  + proto.encode_verify_frame(2, "ed25519", False, 0, *cols,
                                              trace_ctx=b"\x01garbage"))
        replies = {r.request_id: r for r in (rd.read_msg(), rd.read_msg())}
        s.close()
    assert set(replies) == {1, 2}
    for rid, tallied in ((1, 1000), (2, 0)):
        r = replies[rid]
        assert r.status == proto.STATUS_OK and r.tallied == tallied
        assert proto.unpack_mask(r.mask, r.lane_count) == [True, False]
        assert (r.dispatch_id, r.dispatch_lanes, r.dispatch_clients, r.dispatch_traces) == \
            (1, 4, 1, 1)


def test_drain_answers_overloaded(tmp_path):
    with _daemon("port", tmp_path) as srv, _client(srv, "d") as c:
        c.ping()
        assert srv.drain(timeout=5.0)
        with pytest.raises(SidecarOverloaded):
            c.verify("ed25519", _lanes(1))
        assert c.ping().backend == "cpu"  # Ping keeps working while draining


def test_port_daemon_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SidecarServer(f"unix://{tmp_path}/x.sock")


def test_tcp_port_zero_rewrites_addr():
    srv = SidecarServer("tcp://127.0.0.1:0", device="cpu")
    srv.start()
    try:
        assert srv.addr.startswith("tcp://127.0.0.1:") and not srv.addr.endswith(":0")
        with _client(srv, "tcp") as c:
            assert c.ping().backend == "cpu"
    finally:
        srv.stop()


# --- the port's own client, and the entry point ---------------------------------


def test_port_client_against_reference_daemon(tmp_path):
    with _daemon("ref", tmp_path) as srv:
        c = port_client.SidecarClient(srv.addr, client_id="port", request_deadline_s=DEADLINE_S)
        try:
            assert c.connect().version == proto.PROTOCOL_VERSION
            mask, tallied, info = c.verify("ed25519", _lanes(6, bad={0, 4}), tally=True)
            assert mask == [False, True, True, True, False, True] and tallied == 4000
            assert info["dispatch_lanes"] == 6 and info["dispatch_clients"] == 1
            assert c.ping().backend == "cpu"
            assert c.stats()["coalescer"]["dispatches"] == 1
            with pytest.raises(port_client.SidecarError) as err:
                c.verify("curve448", _lanes(1))
            assert err.value.status == proto.STATUS_BAD_REQUEST
            assert c.verify("ed25519", _lanes(1, tag=b"again"))[0] == [True]
        finally:
            c.close()


def test_default_addr(monkeypatch):
    monkeypatch.delenv(port_client.ENV_ADDR, raising=False)
    assert port_client.default_addr("/h") == "unix:///h/data/sidecar.sock"
    assert port_client.default_addr("") == ""
    monkeypatch.setenv(port_client.ENV_ADDR, "tcp://127.0.0.1:9")
    assert port_client.default_addr("/h") == "tcp://127.0.0.1:9"


def test_entry_point_warms_serves_and_drains_on_sigterm(tmp_path):
    """``python -m tmtpu_torch sidecar --device cpu``: warm-up through the
    plain versions, one ready line, a verify from the reference's client,
    then SIGTERM drains and exits 0."""
    sock = f"{tmp_path}/entry.sock"
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "tmtpu_torch", "sidecar", "--addr", f"unix://{sock}",
         "--device", "cpu", "--home", str(tmp_path)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ready = proc.stdout.readline()
        assert ready.startswith(f"Sidecar listening on unix://{sock} backend=cpu"), \
            ready + proc.stderr.read()
        assert float(ready.split("warm_s=")[1].split()[0]) > 0
        client = SidecarClient(f"unix://{sock}", client_id="entry", request_deadline_s=DEADLINE_S)
        try:
            mask, tallied, _ = client.verify("ed25519", _lanes(3, bad={1}, tag=b"e"), tally=True)
        finally:
            client.close()
        assert mask == [True, False, True] and tallied == 2000
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "Drain complete" in out and not os.path.exists(sock)
