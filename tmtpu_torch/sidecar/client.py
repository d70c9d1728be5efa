"""The port's own sidecar client: Hello, then Verify, Ping and Stats over
one connection, one request at a time.

It moves raw (pubkey bytes, msg, sig, power) lanes over the reference's
wire protocol (the VerifyRequest frame written from columns by
``protocol.encode_verify_frame``) and returns the daemon's mask. It has no
fallback: any status other than OK, a lost connection or a missed
deadline raises ``SidecarError``. A node uses the reference's own client
(``tmtpu/sidecar/client.py``, with its breaker and fallback); this one is
for programs of the port, which import nothing of tmtpu.
"""

from __future__ import annotations

import itertools
import json
import os
import socket
import threading
from typing import Dict, List, Optional, Tuple

from tmtpu_torch.sidecar import protocol as proto

ENV_ADDR = "TMTPU_SIDECAR_ADDR"


def default_addr(home: str = "") -> str:
    """``TMTPU_SIDECAR_ADDR``, else ``<home>/data/sidecar.sock``, else ""."""
    env = os.environ.get(ENV_ADDR, "")
    if env:
        return env
    if home:
        return f"unix://{os.path.join(home, 'data', 'sidecar.sock')}"
    return ""


class SidecarError(Exception):
    """A non-OK reply (``status`` holds its code, -1 for a connection or
    protocol failure)."""

    def __init__(self, message: str, status: int = -1):
        super().__init__(message)
        self.status = status


class SidecarClient:
    def __init__(self, addr: str, *, client_id: str = "",
                 connect_timeout_s: float = 2.0,
                 request_deadline_s: float = 10.0,
                 max_frame_bytes: int = proto.DEFAULT_MAX_FRAME_BYTES):
        self.addr = addr
        self.client_id = client_id or f"pid-{os.getpid()}"
        self._connect_timeout_s = connect_timeout_s
        self._request_deadline_s = request_deadline_s
        self._max_frame_bytes = max_frame_bytes
        self._sock: Optional[socket.socket] = None
        self._reader: Optional[proto.FrameReader] = None
        self._lock = threading.Lock()
        self._seq = itertools.count(1)
        self.hello_ack: Optional[proto.HelloAck] = None

    def connect(self) -> proto.HelloAck:
        """Connect and shake hands, if not connected yet."""
        with self._lock:
            self._connect_locked()
            return self.hello_ack

    def _connect_locked(self) -> None:
        if self._sock is not None:
            return
        kind, target = proto.parse_addr(self.addr)
        sock = socket.socket(socket.AF_UNIX if kind == "unix" else socket.AF_INET,
                             socket.SOCK_STREAM)
        try:
            sock.settimeout(self._connect_timeout_s)
            sock.connect(target)
            reader = proto.FrameReader(sock.makefile("rb"), self._max_frame_bytes)
            sock.sendall(proto.encode_frame(proto.Hello(
                version=proto.PROTOCOL_VERSION, client_id=self.client_id,
                features=["verify", "tally"])))
            ack = reader.read_msg()
        except (OSError, EOFError, proto.ProtocolError) as exc:
            sock.close()
            raise SidecarError(f"sidecar {self.addr}: {exc}") from exc
        if not isinstance(ack, proto.HelloAck):
            sock.close()
            detail = (f"code {ack.code}: {ack.message}" if isinstance(ack, proto.ErrorReply)
                      else type(ack).__name__)
            raise SidecarError(f"sidecar rejected the handshake ({detail})")
        self._sock, self._reader, self.hello_ack = sock, reader, ack

    def close(self) -> None:
        with self._lock:
            sock, self._sock, self._reader = self._sock, None, None
            if sock is not None:
                sock.close()

    def _roundtrip(self, frame: bytes, deadline_s: Optional[float]):
        """Send one frame and read its reply, within the deadline."""
        with self._lock:
            self._connect_locked()
            try:
                self._sock.settimeout(deadline_s or self._request_deadline_s)
                self._sock.sendall(frame)
                reply = self._reader.read_msg()
            except (OSError, EOFError, proto.ProtocolError) as exc:
                sock, self._sock, self._reader = self._sock, None, None
                sock.close()
                raise SidecarError(f"sidecar {self.addr}: {exc}") from exc
        if isinstance(reply, proto.ErrorReply):
            raise SidecarError(f"sidecar error {reply.code}: {reply.message}")
        return reply

    def verify(self, curve: str, lanes: List[Tuple[bytes, bytes, bytes, int]],
               tally: bool = False,
               deadline_s: Optional[float] = None,
               trace_ctx: bytes = b"") -> Tuple[List[bool], int, Dict]:
        """Ship (pubkey bytes, msg, sig, power) lanes to the daemon, with a
        v2 trace context when ``trace_ctx`` is given (the encoded
        ``libs.trace.TraceContext``, sent as it is); returns (mask,
        tallied, dispatch info). Raises ``SidecarError`` on any status
        other than OK."""
        deadline_s = deadline_s or self._request_deadline_s
        rid = next(self._seq)
        pks, msgs, sigs, powers = (list(col) for col in zip(*lanes)) if lanes else ([],) * 4
        reply = self._roundtrip(proto.encode_verify_frame(
            rid, curve, tally, int(deadline_s * 1000), pks, msgs, sigs, powers,
            trace_ctx=trace_ctx), deadline_s)
        if not isinstance(reply, proto.VerifyResponse) or reply.request_id != rid:
            raise SidecarError(f"unexpected reply {reply!r}")
        if reply.status != proto.STATUS_OK:
            status = proto.STATUS_NAMES.get(reply.status, str(reply.status))
            raise SidecarError(f"sidecar status {status}: {reply.error}", reply.status)
        if reply.lane_count != len(lanes):
            raise SidecarError(f"sidecar answered {reply.lane_count} lanes for {len(lanes)}")
        info = {"dispatch_id": reply.dispatch_id,
                "dispatch_lanes": reply.dispatch_lanes,
                "dispatch_clients": reply.dispatch_clients,
                "dispatch_traces": reply.dispatch_traces}
        return proto.unpack_mask(reply.mask, reply.lane_count), reply.tallied, info

    def ping(self, deadline_s: Optional[float] = None) -> proto.Pong:
        nonce = next(self._seq)
        reply = self._roundtrip(proto.encode_frame(proto.Ping(nonce=nonce)), deadline_s)
        if not isinstance(reply, proto.Pong) or reply.nonce != nonce:
            raise SidecarError(f"unexpected reply {reply!r}")
        return reply

    def stats(self, deadline_s: Optional[float] = None) -> Dict:
        """The daemon's introspection snapshot."""
        reply = self._roundtrip(proto.encode_frame(proto.StatsRequest()), deadline_s)
        if not isinstance(reply, proto.StatsResponse):
            raise SidecarError(f"unexpected reply {reply!r}")
        return json.loads(reply.stats_json.decode())
