"""The sidecar daemon on the card: socket listener, protocol loop, verify
engine. The port of ``tmtpu/sidecar/server.py``.

The engine is the port's batch verifier on raw lanes
(``crypto/batch.py::verify_lanes``): the columns of a joint dispatch go
through the verify-once resolve against the daemon-wide signature cache
(``sigcache.DEFAULT``, so a triple verified for node A is a hit for node
B, and identical lanes of two clients in one dispatch share one lane),
then one kernel launch per curve. Only the coalescer's dispatcher thread
runs the engine; ``warm()`` runs before ``start()``, so no request waits
for the kernels' build.

There is no CPU fallback, no breaker and no serial re-verify: an engine
failure answers every request of its dispatch with the reference's
status (``STATUS_BACKEND_DOWN``), and the node's own client decides what
to do. As in the reference, one lane whose key has the wrong size fails
its whole dispatch that way (the reference's engine builds a key object
from every lane, and the constructor raises). The reference's health HTTP
listener, metrics and trace spans are not ported; a v2 trace context is
advisory, never rejected, and counted in ``dispatch_traces`` when it
passes the reference's strict decode.

Run it: ``python -m tmtpu_torch sidecar --addr unix:///path/to.sock``.
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import threading
import time
from typing import Dict, Optional

from tmtpu_torch import device as device_mod
from tmtpu_torch.crypto import batch as crypto_batch
from tmtpu_torch.crypto import sigcache
from tmtpu_torch.sidecar import protocol as proto
from tmtpu_torch.sidecar.coalescer import Coalescer, Overloaded

_FAILURE_STATUS = {
    "expired": proto.STATUS_OVERLOADED,
    "engine": proto.STATUS_BACKEND_DOWN,
    "stopped": proto.STATUS_SHUTTING_DOWN,
}

WARM_LANES = 4

# the trace context's wire form (tmtpu/libs/trace.py): version(1) ||
# trace_id(8) || parent_span_id(8) || flags(1) || origin_len(1) || origin
_CTX_WIRE_VERSION = 1
_CTX_MAX_WIRE_BYTES = 64
_CTX_ORIGIN_MAX = 40


def trace_ctx_valid(raw: bytes) -> bool:
    """Whether a received trace context passes the reference's strict
    decode (``TraceContext.decode``); garbage is untraced, not an error."""
    try:
        if (not raw or len(raw) > _CTX_MAX_WIRE_BYTES or len(raw) < 19
                or raw[0] != _CTX_WIRE_VERSION):
            return False
        olen = raw[18]
        if olen > _CTX_ORIGIN_MAX or len(raw) != 19 + olen:
            return False
        raw[19:19 + olen].decode("ascii")
        return True
    except Exception:  # noqa: BLE001 - a malformed context never raises
        return False


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
                 server_id: str = ""):
        self.addr = addr
        self._kind, self._target = proto.parse_addr(addr)
        self.device = device_mod.resolve(device)
        self._max_lanes_per_dispatch = max_lanes_per_dispatch
        self._max_frame_bytes = max_frame_bytes
        self._default_deadline_s = request_deadline_s
        self.server_id = server_id or f"sidecar-{os.getpid()}"
        self.coalescer = Coalescer(
            self._engine_verify,
            max_queue_lanes=max_queue_lanes,
            max_lanes_per_dispatch=max_lanes_per_dispatch)
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
        """Coalescer dispatch target: one curve's joint columns through one
        verify-once flush on the daemon's device."""
        mask, tallied, stats = crypto_batch.verify_lanes(
            curve, pks, msgs, sigs, powers, tally, device=self.device)
        self._last_cache_stats = stats
        return mask, tallied

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
            mask, tallied = self._engine_verify(curve, pks, msgs, sigs,
                                                [1] * WARM_LANES, True)
            if mask != [True] * WARM_LANES or tallied != WARM_LANES:
                raise RuntimeError(f"sidecar warm-up: {curve} self-signed lanes gave "
                                   f"mask {mask}, tally {tallied}")
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
        return {
            "server_id": self.server_id,
            "addr": self.addr,
            "backend": self.backend_name(),
            "device": device_mod.describe(self.device),
            "warmed": self._warmed,
            "draining": self._draining,
            "uptime_s": round(max(0.0, time.monotonic() - self._started_at), 3),
            "connections": n_conns,
            "coalescer": self.coalescer.snapshot(),
            "sigcache": sigcache.stats(),
            "engine": {"last_cache_stats": self._last_cache_stats,
                       "launches": launch_counts()},
        }

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
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="sidecar-conn", daemon=True).start()

    def _drop_conn(self, conn) -> None:
        with self._conns_lock:
            self._conns.discard(conn)
        try:
            conn.close()
        except OSError:
            pass

    def _serve_conn(self, conn: socket.socket) -> None:
        rfile = conn.makefile("rb")
        wlock = threading.Lock()

        def send(msg) -> None:
            data = proto.encode_frame(msg)
            with wlock:
                conn.sendall(data)

        def protocol_error(exc) -> None:
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
                send(proto.ErrorReply(
                    code=proto.ERR_PROTOCOL,
                    message=f"expected Hello, got {type(first).__name__}"))
                return
            if first.version not in proto.SUPPORTED_VERSIONS:
                send(proto.ErrorReply(
                    code=proto.ERR_VERSION,
                    message=f"protocol version {first.version} not in "
                            f"server-supported {list(proto.SUPPORTED_VERSIONS)}"))
                return
            client_id = first.client_id or "anon"
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
                        self._handle_verify(client_id, proto.decode_verify_columns(body), send)
                        continue
                    msg = proto.decode_frame(body)
                except proto.ProtocolError as exc:
                    protocol_error(exc)
                    return  # framing is lost; the stream cannot recover
                if isinstance(msg, proto.Ping):
                    send(proto.Pong(
                        nonce=msg.nonce, backend=self.backend_name(),
                        uptime_ms=int((time.monotonic() - self._started_at) * 1000)))
                elif isinstance(msg, proto.StatsRequest):
                    send(proto.StatsResponse(stats_json=json.dumps(self.snapshot()).encode()))
                else:
                    send(proto.ErrorReply(code=proto.ERR_PROTOCOL,
                                          message=f"unexpected {type(msg).__name__}"))
        except (EOFError, OSError):
            pass  # the peer went away
        finally:
            self._drop_conn(conn)

    def _handle_verify(self, client_id: str, req: proto.VerifyColumns, send) -> None:
        n = len(req.sigs)

        def reject(status: int, error: str) -> None:
            send(proto.VerifyResponse(request_id=req.request_id, status=status,
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
        try:
            pending = self.coalescer.submit(
                client_id, req.curve, req.pks, req.msgs, req.sigs, req.powers, req.tally,
                deadline_s=deadline_s,
                traced=bool(req.trace_ctx) and trace_ctx_valid(bytes(req.trace_ctx)))
        except Overloaded as exc:
            reject(proto.STATUS_OVERLOADED, str(exc))
            return

        def finish() -> None:
            # grace over the deadline: the coalescer answers expiry itself;
            # this wait only guards a wedged dispatch
            try:
                if not pending.wait(deadline_s + 5.0):
                    reject(proto.STATUS_BACKEND_DOWN, "dispatch wedged past deadline")
                elif pending.mask is None:
                    reject(_FAILURE_STATUS.get(pending.failure, proto.STATUS_BACKEND_DOWN),
                           pending.error or "verify failed")
                else:
                    send(proto.VerifyResponse(
                        request_id=req.request_id,
                        status=proto.STATUS_OK,
                        mask=proto.pack_mask(pending.mask),
                        lane_count=len(pending.mask),
                        tallied=pending.tallied,
                        dispatch_id=pending.dispatch_id,
                        dispatch_lanes=pending.dispatch_lanes,
                        dispatch_clients=pending.dispatch_clients,
                        dispatch_traces=pending.dispatch_traces))
            except OSError:
                pass  # the client is gone; the dispatch already happened

        # answer off-thread so the connection keeps reading: one client can
        # pipeline request ids, and they coalesce with each other
        threading.Thread(target=finish, name="sidecar-reply", daemon=True).start()
