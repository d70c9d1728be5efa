"""The sidecar daemon on the card: socket listener, protocol loop, verify
engine. The port of ``tmtpu/sidecar/server.py``.

The engine is the port's batch verifier on raw lanes
(``crypto/batch.py::verify_lanes``): the columns of a joint dispatch go
through the verify-once resolve against the daemon-wide signature cache
(``sigcache.DEFAULT``, so a triple verified for node A is a hit for node
B, and identical lanes of two clients in one dispatch share one lane),
then one kernel launch per curve on the daemon's one device. Only the
coalescer's dispatcher thread runs the engine; ``warm()`` runs before
``start()``, so no request waits for the kernels' build.

There is no CPU fallback, no breaker and no serial re-verify: an engine
failure answers every request of its dispatch with the reference's
status (``STATUS_BACKEND_DOWN``), and the node's own client decides what
to do. As in the reference, one lane whose key has the wrong size fails
its whole dispatch that way (the reference's engine builds a key object
from every lane, and the constructor raises). A v2 trace context is
advisory, never rejected: it is decoded strictly (``trace.adopt``),
counted in ``trace_context_rx_total`` or ``trace_context_invalid_total``
(``transport="sidecar"``), and a valid one rides its request to the
coalescer, which counts it in ``dispatch_traces`` and marks the dispatch
with it.

Spans of a verify request, on ``time.perf_counter()``, each tagged with
the Hello's ``client`` and the wire's ``request_id``: ``sidecar.recv``
(from the frame's decoded length prefix to its last byte, never the wait
for the frame to begin; ``bytes``), ``sidecar.decode`` (the columnar
decode; ``lanes``, ``bytes``, ``walk``: "native" for the C walk of the
frame, "python" for the plain one), ``sidecar.admit`` (the checks, the trace
context, the submit and the reply thread's start; ``lanes``), the
coalescer's ``coalescer.queue_wait`` and ``coalescer.dispatch``, then on
the reply thread ``sidecar.handoff`` (from the dispatcher's wake-up of the
request to this thread's) and ``sidecar.reply`` (the mask's pack, the
encode and the send; ``lanes``, ``bytes``).

Health (``health_laddr``, ``host:port``): an HTTP listener serves
``/healthz`` (200 or 503, ``{"healthy": ..., **snapshot()}`` as JSON) and
``/metrics`` (the daemon's ``sidecar_server_*`` families,
``sidecar/metrics.py``, and the process-wide device-path families,
``libs/metrics.py``, sorted by name as the reference renders its one
registry), 404 elsewhere, as the reference's does. As in the reference,
no endpoint drains the span ring. With no
breaker to read, the port's signal is its engine: unhealthy once
``failure_threshold`` dispatches in a row have failed (the reference's
``[crypto] breaker_failure_threshold``, after which its device breaker
opens), healthy again after one that answers. It changes no routing: a
failed dispatch is answered ``STATUS_BACKEND_DOWN`` either way.

Run it: ``python -m tmtpu_torch sidecar --addr unix:///path/to.sock``.
"""

from __future__ import annotations

import hashlib
import http.server
import json
import os
import socket
import threading
import time
from typing import Dict, Optional

from tmtpu_torch import device as device_mod
from tmtpu_torch.crypto import batch as crypto_batch
from tmtpu_torch.crypto import sigcache
from tmtpu_torch.libs import metrics as lib_metrics
from tmtpu_torch.libs import trace
from tmtpu_torch.sidecar import protocol as proto
from tmtpu_torch.sidecar.coalescer import Coalescer, Overloaded
from tmtpu_torch.sidecar.metrics import SidecarMetrics

_FAILURE_STATUS = {
    "expired": proto.STATUS_OVERLOADED,
    "engine": proto.STATUS_BACKEND_DOWN,
    "stopped": proto.STATUS_SHUTTING_DOWN,
}

WARM_LANES = 4


def trace_ctx_valid(raw: bytes) -> bool:
    """Whether a received trace context passes the strict decode
    (``trace.TraceContext.decode``); garbage is untraced, not an error."""
    return trace.TraceContext.decode(raw) is not None


def launch_counts() -> Dict[str, int]:
    """Each kernel's launches in this process so far."""
    from tmtpu_torch.gpu import k1_kernel, kernel

    return {"ed25519_verify": kernel.LAUNCHES, "sr25519_verify": kernel.SR_LAUNCHES,
            "k1_verify": k1_kernel.LAUNCHES}


def _self_signed(curve: str, n: int):
    """n lanes of one deterministic key of ``curve`` signing n messages."""
    from tmtpu_torch.crypto.ed25519 import PrivKeyEd25519
    from tmtpu_torch.crypto.secp256k1 import PrivKeySecp256k1
    from tmtpu_torch.crypto.sr25519 import PrivKeySr25519

    cls = {crypto_batch.ED25519: PrivKeyEd25519, crypto_batch.SR25519: PrivKeySr25519,
           crypto_batch.SECP256K1: PrivKeySecp256k1}[curve]
    priv = cls(hashlib.sha256(b"sidecar-warm " + curve.encode()).digest())
    pk = priv.pub_key().bytes()
    msgs = [b"sidecar-warm-%d" % i for i in range(n)]
    return [pk] * n, msgs, [priv.sign(m) for m in msgs]


class SidecarServer:
    def __init__(self, addr: str, *,
                 device=None,
                 max_queue_lanes: int = 65536,
                 max_lanes_per_dispatch: int = 40960,
                 max_frame_bytes: int = proto.DEFAULT_MAX_FRAME_BYTES,
                 request_deadline_s: float = 30.0,
                 health_laddr: str = "",
                 failure_threshold: int = 3,
                 server_id: str = ""):
        self.addr = addr
        self._kind, self._target = proto.parse_addr(addr)
        self.device = device_mod.resolve(device)
        self._max_lanes_per_dispatch = max_lanes_per_dispatch
        self._max_frame_bytes = max_frame_bytes
        self._default_deadline_s = request_deadline_s
        self.health_laddr = health_laddr
        self._failure_threshold = failure_threshold
        self._health_httpd = None
        self._health_thread: Optional[threading.Thread] = None
        self.server_id = server_id or f"sidecar-{os.getpid()}"
        self._max_queue_lanes = max_queue_lanes
        self.metrics = SidecarMetrics()
        self.coalescer = Coalescer(
            self._verify_mask,
            max_queue_lanes=max_queue_lanes,
            max_lanes_per_dispatch=max_lanes_per_dispatch,
            metrics=self.metrics)
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._running = False
        self._draining = False
        self._started_at = 0.0
        self._warmed = False
        self._last_cache_stats: Dict = {}

    # --- verify engine ---

    def _engine_verify(self, curve, pks, msgs, sigs, powers, tally):
        """One curve's joint columns through one verify-once flush on the
        daemon's device. Returns ``(mask, 0, 0)``: only the mask is read.
        The zeros keep the places of the flush's tally and mesh count, since
        the planted-fault double ``benchmark/tests/fault_host.py`` wraps
        this method and unpacks three values; they go when it takes a mask."""
        mask, self._last_cache_stats = crypto_batch.verify_lanes(
            curve, pks, msgs, sigs, powers, tally, device=self.device)
        return mask, 0, 0

    def _verify_mask(self, curve, pks, msgs, sigs, powers, tally):
        """The coalescer's ``VerifyFn``: the engine's mask alone."""
        return self._engine_verify(curve, pks, msgs, sigs, powers, tally)[0]

    def backend_name(self) -> str:
        return "gpu" if self.device.type == "cuda" else "cpu"

    def warm(self) -> float:
        """Build the three kernels (on the card) and the C host prep now,
        and push one self-signed batch of each curve through the engine, so
        no request pays for them. Raises on any wrong verdict. Returns the
        wall seconds."""
        from tmtpu_torch import native
        from tmtpu_torch.gpu import build

        t0 = time.perf_counter()
        if self.device.type == "cuda":
            build.build_all()
        native.build()
        for curve in crypto_batch.PUB_KEY_SIZES:
            pks, msgs, sigs = _self_signed(curve, WARM_LANES)
            mask = self._verify_mask(curve, pks, msgs, sigs, [1] * WARM_LANES, True)
            if mask != [True] * WARM_LANES:
                raise RuntimeError(f"sidecar warm-up: {curve} self-signed lanes gave "
                                   f"mask {mask}")
        self._warmed = True
        return time.perf_counter() - t0

    # --- lifecycle ---

    def start(self) -> None:
        if self._running:
            return
        if self._kind == "unix":
            path = self._target
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.bind(path)
        else:
            host, port = self._target
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((host, port))
            if port == 0:
                # an ephemeral port: give the real endpoint back on addr
                port = sock.getsockname()[1]
                self._target = (host, port)
                self.addr = f"tcp://{host}:{port}"
        sock.listen(64)
        self._listener = sock
        self._running = True
        self._started_at = time.monotonic()
        self.coalescer.start()
        if self.health_laddr:
            self._start_health_http()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="sidecar-accept", daemon=True)
        self._accept_thread.start()

    def _close_listener(self) -> None:
        listener, self._listener = self._listener, None
        if listener is None:
            return
        # shutdown() before close(): close() alone does not wake a thread
        # blocked in accept()
        try:
            listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            listener.close()
        except OSError:
            pass

    def drain(self, timeout: float = 30.0) -> bool:
        """Shutdown, phase one: close the listener, answer every later
        VerifyRequest with STATUS_OVERLOADED, and block until the
        coalescer has dispatched its queue and answered every batch in
        flight, or the timeout passes (returns False). Ping and Stats keep
        working. Call stop() afterwards."""
        self._draining = True
        self._close_listener()
        return self.coalescer.drain(timeout)

    def stop(self) -> None:
        self._running = False
        self._close_listener()
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        self.coalescer.stop()
        httpd, self._health_httpd = self._health_httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
            self._health_thread.join(timeout=5.0)
            self._health_thread = None
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
            self._accept_thread = None
        if self._kind == "unix":
            try:
                os.unlink(self._target)
            except OSError:
                pass

    def snapshot(self) -> Dict:
        with self._conns_lock:
            n_conns = len(self._conns)
        failures, last_error = self.coalescer.engine_failures()
        return {
            "server_id": self.server_id,
            "addr": self.addr,
            "backend": self.backend_name(),
            "device": device_mod.describe(self.device),
            "warmed": self._warmed,
            "draining": self._draining,
            "uptime_s": round(max(0.0, time.monotonic() - self._started_at), 3),
            "connections": n_conns,
            "limits": {"max_queue_lanes": self._max_queue_lanes,
                       "max_lanes_per_dispatch": self._max_lanes_per_dispatch,
                       "max_frame_bytes": self._max_frame_bytes,
                       "request_deadline_s": self._default_deadline_s},
            "coalescer": self.coalescer.snapshot(),
            "sigcache": sigcache.stats(),
            "engine": {"last_cache_stats": self._last_cache_stats,
                       "launches": launch_counts(),
                       "failures": failures,
                       "failure_threshold": self._failure_threshold,
                       "last_error": last_error},
        }

    def healthy(self) -> bool:
        """False once ``failure_threshold`` engine dispatches in a row have
        failed, until one answers."""
        return self.coalescer.engine_failures()[0] < self._failure_threshold

    # --- connection handling ---

    def _accept_loop(self) -> None:
        while self._running:
            listener = self._listener
            if listener is None:
                return
            try:
                conn, _peer = listener.accept()
            except OSError:
                return  # listener closed
            with self._conns_lock:
                self._conns.add(conn)
                self.metrics.connections.set(len(self._conns))
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="sidecar-conn", daemon=True).start()

    def _drop_conn(self, conn) -> None:
        with self._conns_lock:
            self._conns.discard(conn)
            self.metrics.connections.set(len(self._conns))
        try:
            conn.close()
        except OSError:
            pass

    def _serve_conn(self, conn: socket.socket) -> None:
        rfile = conn.makefile("rb")
        wlock = threading.Lock()

        def send(msg) -> int:
            data = proto.encode_frame(msg)
            with wlock:
                conn.sendall(data)
            return len(data)

        def protocol_error(exc) -> None:
            self.metrics.protocol_errors.inc(kind="bad-frame")
            try:
                send(proto.ErrorReply(code=proto.ERR_PROTOCOL, message=str(exc)))
            except OSError:
                pass

        reader = proto.FrameReader(rfile, self._max_frame_bytes)
        try:
            # handshake: Hello first, its version within SUPPORTED_VERSIONS
            try:
                first = reader.read_msg()
            except proto.ProtocolError as exc:
                protocol_error(exc)
                return
            if not isinstance(first, proto.Hello):
                self.metrics.protocol_errors.inc(kind="no-hello")
                send(proto.ErrorReply(
                    code=proto.ERR_PROTOCOL,
                    message=f"expected Hello, got {type(first).__name__}"))
                return
            if first.version not in proto.SUPPORTED_VERSIONS:
                self.metrics.protocol_errors.inc(kind="version-mismatch")
                send(proto.ErrorReply(
                    code=proto.ERR_VERSION,
                    message=f"protocol version {first.version} not in "
                            f"server-supported {list(proto.SUPPORTED_VERSIONS)}"))
                return
            client_id = first.client_id or "anon"
            requests = self.metrics.requests
            requests.inc(type="hello")
            send(proto.HelloAck(
                version=min(first.version, proto.PROTOCOL_VERSION),
                server_id=self.server_id,
                backend=self.backend_name(),
                max_lanes=self._max_lanes_per_dispatch,
                max_frame_bytes=self._max_frame_bytes))
            while self._running:
                try:
                    body = reader.read_body()
                    if body and body[0] == proto.VERIFY_REQUEST_TYPE:
                        with trace.span("sidecar.decode", bytes=len(body),
                                        client=client_id) as sp:
                            columns, walk = proto.decode_verify_walk(body)
                            sp.set(lanes=len(columns.sigs), request_id=columns.request_id,
                                   walk=walk)
                        tags = {"client": client_id, "request_id": columns.request_id}
                        trace.record("sidecar.recv", *reader.body_s, bytes=len(body), **tags)
                        requests.inc(type="verify")
                        with trace.span("sidecar.admit", lanes=len(columns.sigs), **tags):
                            self._handle_verify(client_id, columns, send)
                        continue
                    msg = proto.decode_frame(body)
                except proto.ProtocolError as exc:
                    protocol_error(exc)
                    return  # framing is lost; the stream cannot recover
                if isinstance(msg, proto.Ping):
                    requests.inc(type="ping")
                    send(proto.Pong(
                        nonce=msg.nonce, backend=self.backend_name(),
                        uptime_ms=int((time.monotonic() - self._started_at) * 1000)))
                elif isinstance(msg, proto.StatsRequest):
                    requests.inc(type="stats")
                    send(proto.StatsResponse(stats_json=json.dumps(self.snapshot()).encode()))
                else:
                    self.metrics.protocol_errors.inc(kind="unexpected-type")
                    send(proto.ErrorReply(code=proto.ERR_PROTOCOL,
                                          message=f"unexpected {type(msg).__name__}"))
        except (EOFError, OSError):
            pass  # the peer went away
        finally:
            self._drop_conn(conn)

    def _handle_verify(self, client_id: str, req: proto.VerifyColumns, send) -> None:
        n = len(req.sigs)
        tags = {"client": client_id, "request_id": req.request_id}

        def reject(status: int, error: str) -> int:
            return send(proto.VerifyResponse(request_id=req.request_id, status=status,
                                             lane_count=n, error=error))

        if self._draining:
            # OVERLOADED, not SHUTTING_DOWN: a node's client falls back
            # without charging its breaker
            reject(proto.STATUS_OVERLOADED, "daemon draining for shutdown")
            return
        if req.curve not in crypto_batch.PUB_KEY_SIZES:
            reject(proto.STATUS_BAD_REQUEST, f"unknown curve {req.curve!r}")
            return
        if not n:
            reject(proto.STATUS_BAD_REQUEST, "zero lanes")
            return
        if n > self._max_lanes_per_dispatch:
            reject(proto.STATUS_OVERLOADED,
                   f"{n} lanes exceeds per-request cap {self._max_lanes_per_dispatch}")
            return
        deadline_s = (req.deadline_ms / 1000.0 if req.deadline_ms
                      else self._default_deadline_s)
        # v2 trace context: strict decode, garbage is untraced (advisory,
        # never rejected)
        trace_ctx = None
        if req.trace_ctx:
            trace_ctx = trace.adopt(bytes(req.trace_ctx))
            counter = (lib_metrics.trace_context_invalid if trace_ctx is None
                       else lib_metrics.trace_context_rx)
            counter.inc(transport="sidecar")
        try:
            pending = self.coalescer.submit(
                client_id, req.curve, req.pks, req.msgs, req.sigs, req.powers, req.tally,
                deadline_s=deadline_s, trace_ctx=trace_ctx, request_id=req.request_id)
        except Overloaded as exc:
            reject(proto.STATUS_OVERLOADED, str(exc))
            return

        def finish() -> None:
            # grace over the deadline: the coalescer answers expiry itself;
            # this wait only guards a wedged dispatch
            answered = pending.wait(deadline_s + 5.0)
            if answered:
                trace.record("sidecar.handoff", pending.done_at, time.perf_counter(), **tags)
            try:
                with trace.span("sidecar.reply", lanes=n, **tags) as sp:
                    if not answered:
                        sent = reject(proto.STATUS_BACKEND_DOWN, "dispatch wedged past deadline")
                    elif pending.mask is None:
                        sent = reject(
                            _FAILURE_STATUS.get(pending.failure, proto.STATUS_BACKEND_DOWN),
                            pending.error or "verify failed")
                    else:
                        sent = send(proto.VerifyResponse(
                            request_id=req.request_id,
                            status=proto.STATUS_OK,
                            mask=proto.pack_mask(pending.mask),
                            lane_count=len(pending.mask),
                            tallied=pending.tallied,
                            dispatch_id=pending.dispatch_id,
                            dispatch_lanes=pending.dispatch_lanes,
                            dispatch_clients=pending.dispatch_clients,
                            dispatch_traces=pending.dispatch_traces))
                    sp.set(bytes=sent)
            except OSError:
                pass  # the client is gone; the dispatch already happened

        # answer off-thread so the connection keeps reading: one client can
        # pipeline request ids, and they coalesce with each other
        threading.Thread(target=finish, name="sidecar-reply", daemon=True).start()

    # --- health HTTP ---

    def _start_health_http(self) -> None:
        """Listen on ``health_laddr``; port 0 takes a free port, written back
        to ``health_laddr``."""
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path.startswith("/healthz"):
                    healthy = server.healthy()
                    body = json.dumps({"healthy": healthy, **server.snapshot()}).encode()
                    self.send_response(200 if healthy else 503)
                    ctype = "application/json"
                elif self.path.startswith("/metrics"):
                    body = lib_metrics.render(lib_metrics.DEFAULT,
                                              server.metrics.registry).encode()
                    self.send_response(200)
                    ctype = "text/plain; version=0.0.4"
                else:
                    body = b"not found\n"
                    self.send_response(404)
                    ctype = "text/plain"
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        host, _sep, port = self.health_laddr.rpartition(":")
        host = host or "127.0.0.1"
        httpd = http.server.ThreadingHTTPServer((host, int(port)), Handler)
        self.health_laddr = f"{host}:{httpd.server_address[1]}"
        self._health_httpd = httpd
        self._health_thread = threading.Thread(
            target=httpd.serve_forever, name="sidecar-health", daemon=True)
        self._health_thread.start()
