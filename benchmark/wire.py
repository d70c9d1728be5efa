"""The benchmark's own frozen copy of the sidecar wire protocol.

The frames a node sends the daemon and the replies it reads back, byte for
byte as the daemon's codec writes them (protocol version 2):

    frame   = uvarint(len(body)) || body
    body    = type_byte || protobuf payload (proto3: zero scalars omitted,
              fields in ascending order, negative varints in ten bytes)

Only what a client needs is here: ``Hello``, a ``VerifyRequest`` built from
pre-encoded lanes, ``StatsRequest``, and the decode of ``HelloAck``,
``VerifyResponse``, ``StatsResponse`` and ``ErrorReply``. The nodes'
encoding is not the system's work, and a change to the daemon's codec must
not move the yardstick, so nothing here imports the program.
"""

from __future__ import annotations

import json
import socket
from typing import Dict, Iterable, List, Tuple

PROTOCOL_VERSION = 2
MAX_FRAME_BYTES = 8 * 1024 * 1024

HELLO, HELLO_ACK, VERIFY_REQUEST, VERIFY_RESPONSE = 1, 2, 3, 4
STATS_REQUEST, STATS_RESPONSE, ERROR_REPLY = 7, 8, 9

STATUS_OK = 0

# field number -> (name, kind) of each reply a client decodes; kind is
# "u" (unsigned varint), "i" (signed int64 varint) or "b" (bytes/string)
_REPLIES: Dict[int, Dict[int, Tuple[str, str]]] = {
    HELLO_ACK: {1: ("version", "u"), 2: ("server_id", "b"), 3: ("backend", "b"),
                4: ("max_lanes", "u"), 5: ("max_frame_bytes", "u")},
    VERIFY_RESPONSE: {1: ("request_id", "u"), 2: ("status", "u"), 3: ("mask", "b"),
                      4: ("lane_count", "u"), 5: ("tallied", "i"), 6: ("dispatch_id", "u"),
                      7: ("dispatch_lanes", "u"), 8: ("dispatch_clients", "u"),
                      9: ("error", "b"), 10: ("dispatch_traces", "u")},
    STATS_RESPONSE: {1: ("stats_json", "b")},
    ERROR_REPLY: {1: ("request_id", "u"), 2: ("code", "u"), 3: ("message", "b")},
}


class WireError(Exception):
    """A malformed frame, or a reply of the wrong kind."""


def uvarint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_uvarint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise WireError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise WireError("varint too long")


def _varint_field(fn: int, value: int) -> bytes:
    if not value:
        return b""
    return uvarint(fn << 3) + uvarint(value % (1 << 64))


def _bytes_field(fn: int, value: bytes) -> bytes:
    if not value:
        return b""
    return uvarint((fn << 3) | 2) + uvarint(len(value)) + value


def _frame(type_byte: int, payload: bytes) -> bytes:
    body = bytes([type_byte]) + payload
    return uvarint(len(body)) + body


def hello_frame(client_id: str, features: Iterable[str] = ("verify", "tally")) -> bytes:
    payload = _varint_field(1, PROTOCOL_VERSION) + _bytes_field(2, client_id.encode())
    for f in features:
        # a repeated string is written even when empty
        payload += uvarint((3 << 3) | 2) + uvarint(len(f)) + f.encode()
    return _frame(HELLO, payload)


def stats_frame() -> bytes:
    return _frame(STATS_REQUEST, b"")


def lane_blob(pk: bytes, msg: bytes, sig: bytes, power: int) -> bytes:
    """One ``VerifyRequest.lanes`` entry, tag and length included."""
    lane = (_bytes_field(1, pk) + _bytes_field(2, msg) + _bytes_field(3, sig)
            + _varint_field(4, power))
    return b"\x2a" + uvarint(len(lane)) + lane


def verify_frame(request_id: int, curve: str, tally: bool, deadline_ms: int,
                 lanes: bytes) -> bytes:
    """A VerifyRequest frame around ``lanes``, the concatenated
    ``lane_blob``s of the request in order."""
    head = (_varint_field(1, request_id) + _bytes_field(2, curve.encode())
            + _varint_field(3, 1 if tally else 0) + _varint_field(4, deadline_ms))
    body_len = 1 + len(head) + len(lanes)
    return b"".join((uvarint(body_len), bytes([VERIFY_REQUEST]), head, lanes))


def decode_body(body: bytes) -> Tuple[int, Dict]:
    """(type byte, fields) of one reply frame's body; unknown fields are
    skipped by wire type."""
    if not body:
        raise WireError("empty frame")
    spec = _REPLIES.get(body[0])
    if spec is None:
        raise WireError(f"unexpected message type {body[0]}")
    out: Dict = {name: (b"" if kind == "b" else 0) for name, kind in spec.values()}
    pos = 1
    while pos < len(body):
        key, pos = _read_uvarint(body, pos)
        fn, wt = key >> 3, key & 7
        if wt == 0:
            value, pos = _read_uvarint(body, pos)
        elif wt == 2:
            n, pos = _read_uvarint(body, pos)
            if pos + n > len(body):
                raise WireError("truncated bytes field")
            value, pos = body[pos:pos + n], pos + n
        elif wt == 1:
            value, pos = None, pos + 8
        elif wt == 5:
            value, pos = None, pos + 4
        else:
            raise WireError(f"unsupported wire type {wt}")
        field = spec.get(fn)
        if field is None or value is None:
            continue
        name, kind = field
        if kind == "i" and value >= 1 << 63:
            value -= 1 << 64
        out[name] = value
    return body[0], out


def unpack_mask(packed: bytes, lane_count: int):
    """The verdicts of a reply as a bool array: lane i's is bit ``i & 7``
    of byte ``i >> 3``, LSB first."""
    import numpy as np

    if len(packed) < (lane_count + 7) // 8:
        raise WireError(f"mask of {len(packed)} bytes for {lane_count} lanes")
    return np.unpackbits(np.frombuffer(packed, dtype=np.uint8), count=lane_count,
                         bitorder="little").astype(bool)


class FrameSocket:
    """Reads whole frames from a connected socket."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._buf = bytearray()

    def _fill(self, n: int) -> None:
        while len(self._buf) < n:
            chunk = self.sock.recv(max(65536, n - len(self._buf)))
            if not chunk:
                raise EOFError("the daemon closed the connection")
            self._buf += chunk

    def read_body(self) -> bytes:
        pos = 0
        while True:
            self._fill(pos + 1)
            if not self._buf[pos] & 0x80:
                break
            pos += 1
            if pos > 9:
                raise WireError("frame length varint too long")
        n, start = _read_uvarint(bytes(self._buf[:pos + 1]), 0)
        if n > MAX_FRAME_BYTES:
            raise WireError(f"frame of {n} bytes")
        self._fill(start + n)
        body = bytes(self._buf[start:start + n])
        del self._buf[:start + n]
        return body


def parse_addr(addr: str):
    """(socket family, address) of ``unix:///path`` or ``tcp://host:port``."""
    if addr.startswith("unix://"):
        return socket.AF_UNIX, addr[len("unix://"):]
    if addr.startswith("tcp://"):
        host, _, port = addr[len("tcp://"):].rpartition(":")
        return socket.AF_INET, (host, int(port))
    raise ValueError(f"address must be unix:// or tcp://, got {addr!r}")


def connect(addr: str, client_id: str, timeout_s: float = 10.0) -> Tuple[socket.socket, FrameSocket]:
    """A connection that has shaken hands with the daemon."""
    family, target = parse_addr(addr)
    sock = socket.socket(family, socket.SOCK_STREAM)
    sock.settimeout(timeout_s)
    sock.connect(target)
    reader = FrameSocket(sock)
    sock.sendall(hello_frame(client_id))
    kind, fields = decode_body(reader.read_body())
    if kind != HELLO_ACK:
        sock.close()
        raise WireError(f"handshake refused: {fields}")
    sock.settimeout(None)
    return sock, reader


def stats(sock: socket.socket, reader: FrameSocket) -> Dict:
    """The daemon's Stats snapshot, as JSON."""
    sock.sendall(stats_frame())
    kind, fields = decode_body(reader.read_body())
    if kind != STATS_RESPONSE:
        raise WireError(f"expected StatsResponse, got type {kind}: {fields}")
    return json.loads(fields["stats_json"])
