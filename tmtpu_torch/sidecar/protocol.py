"""Sidecar wire protocol: the port's own copy of the reference's codec
(``tmtpu/sidecar/protocol.py``), byte for byte the same frames.

Framing (``tmtpu_torch/sidecar/protoio.py`` primitives):

    frame   = uvarint(len(body)) || body
    body    = type_byte || payload
    payload = protobuf encoding of the message class for type_byte

Both sides enforce ``max_frame_bytes`` (default 8 MiB) before decoding a
single field; a VerifyRequest of 10,000 lanes of (32 B key, ~110 B
message, 64 B signature) is ~2.2 MB.

Handshake: the client sends ``Hello`` first; the server answers
``HelloAck`` with the negotiated version (the lower of both sides, from
``SUPPORTED_VERSIONS``) or ``ErrorReply`` (``ERR_VERSION``) and closes.
Anything else first is a protocol error. Version 2 adds the optional
trace context (``VerifyRequest.trace_ctx``, ``VerifyResponse.
dispatch_traces``); a version-1 peer skips them as unknown fields.

Verify masks travel bit-packed: lane i's verdict is bit ``i & 7`` of byte
``i >> 3``, LSB-first.

Beside the generic codec, which stays as the plain version, the daemon
and the port's client take a columnar path for the one large message:
``decode_verify_columns`` walks a ``VerifyRequest`` once into four columns
(keys, messages, signatures, powers) with no ``Lane`` objects, and
``encode_verify_frame`` writes the same bytes as ``encode_frame`` from
such columns. Both give exactly what the generic codec gives, errors
included. The walk of a body is C (``native.walk_verify``, which records
where each field lies): its offsets become the columns directly, a
``ByteColumn`` a field over the body itself and the powers an
``IntColumn`` (``crypto/lanes.py``), so nothing is cut out of the body. A
body holding anything the C walk does not take goes through the Python
walk (``_walk_verify_request``), which stays as the plain version and
gives lists; a column compares equal to the list of the same values. The
C build is loaded at the first decode, so a client that only encodes
needs no C compiler.
"""

from __future__ import annotations

import io
import time
from typing import Dict, List, NamedTuple, Tuple, Type

import numpy as np

from tmtpu_torch.crypto import lanes
from tmtpu_torch.sidecar.protoio import (
    DelimitedReader,
    ProtoMessage,
    encode_uvarint,
    encode_varint,
)

PROTOCOL_VERSION = 2
# every version the daemon speaks; the negotiated one is min(client, server)
SUPPORTED_VERSIONS = (1, 2)
# first version carrying trace-context fields
TRACE_CTX_MIN_VERSION = 2

DEFAULT_MAX_FRAME_BYTES = 8 * 1024 * 1024

# --- VerifyResponse.status ---
STATUS_OK = 0
STATUS_OVERLOADED = 1      # admission control rejected; retry or fall back
STATUS_BACKEND_DOWN = 2    # the verify engine failed
STATUS_BAD_REQUEST = 3     # unknown curve, zero lanes, malformed lane
STATUS_SHUTTING_DOWN = 4   # daemon draining; do not resubmit

STATUS_NAMES = {
    STATUS_OK: "ok",
    STATUS_OVERLOADED: "overloaded",
    STATUS_BACKEND_DOWN: "backend_down",
    STATUS_BAD_REQUEST: "bad_request",
    STATUS_SHUTTING_DOWN: "shutting_down",
}

# --- ErrorReply.code ---
ERR_VERSION = 1        # Hello.version not in SUPPORTED_VERSIONS
ERR_PROTOCOL = 2       # bad frame / unexpected message sequence
ERR_INTERNAL = 3       # server bug; connection stays usable


class Hello(ProtoMessage):
    FIELDS = [
        (1, "version", "uint32"),
        (2, "client_id", "string"),
        (3, "features", ("rep", "string")),
    ]


class HelloAck(ProtoMessage):
    FIELDS = [
        (1, "version", "uint32"),
        (2, "server_id", "string"),
        (3, "backend", "string"),           # "gpu" | "cpu" from this daemon
        (4, "max_lanes", "uint32"),          # per-request admission cap
        (5, "max_frame_bytes", "uint64"),
    ]


class Lane(ProtoMessage):
    """One signature to check; ``power`` rides along for verify + tally."""

    FIELDS = [
        (1, "pub_key", "bytes"),
        (2, "msg", "bytes"),
        (3, "sig", "bytes"),
        (4, "power", "int64"),
    ]


class VerifyRequest(ProtoMessage):
    FIELDS = [
        (1, "request_id", "uint64"),
        (2, "curve", "string"),             # "ed25519" | "sr25519" | "secp256k1"
        (3, "tally", "bool"),
        (4, "deadline_ms", "uint32"),        # 0 = server default
        (5, "lanes", ("rep", ("msg", Lane))),
        (6, "trace_ctx", "bytes"),           # v2, empty = untraced
    ]


class VerifyResponse(ProtoMessage):
    FIELDS = [
        (1, "request_id", "uint64"),
        (2, "status", "uint32"),
        (3, "mask", "bytes"),                # bit-packed, lane_count bits
        (4, "lane_count", "uint32"),
        (5, "tallied", "int64"),
        (6, "dispatch_id", "uint64"),        # joint-dispatch identity,
        (7, "dispatch_lanes", "uint32"),     # the lanes it carried,
        (8, "dispatch_clients", "uint32"),   # the distinct clients in it
        (9, "error", "string"),
        (10, "dispatch_traces", "uint32"),   # v2: traced requests in it
    ]


class Ping(ProtoMessage):
    FIELDS = [(1, "nonce", "uint64")]


class Pong(ProtoMessage):
    FIELDS = [
        (1, "nonce", "uint64"),
        (2, "backend", "string"),
        (3, "uptime_ms", "uint64"),
    ]


class StatsRequest(ProtoMessage):
    FIELDS = []


class StatsResponse(ProtoMessage):
    """Introspection snapshot as a JSON object (advisory)."""

    FIELDS = [(1, "stats_json", "bytes")]


class ErrorReply(ProtoMessage):
    FIELDS = [
        (1, "request_id", "uint64"),         # 0 when not tied to a request
        (2, "code", "uint32"),
        (3, "message", "string"),
    ]


# type_byte -> message class; the numbers are wire-visible
MESSAGE_TYPES: Dict[int, Type[ProtoMessage]] = {
    1: Hello,
    2: HelloAck,
    3: VerifyRequest,
    4: VerifyResponse,
    5: Ping,
    6: Pong,
    7: StatsRequest,
    8: StatsResponse,
    9: ErrorReply,
}

TYPE_BYTES: Dict[Type[ProtoMessage], int] = {
    cls: tb for tb, cls in MESSAGE_TYPES.items()
}
VERIFY_REQUEST_TYPE = TYPE_BYTES[VerifyRequest]


class ProtocolError(Exception):
    """Raised on malformed frames, unknown types, or bad sequencing."""


def encode_frame(msg: ProtoMessage) -> bytes:
    tb = TYPE_BYTES.get(type(msg))
    if tb is None:
        raise ProtocolError(f"unregistered message type {type(msg).__name__}")
    body = bytes([tb]) + msg.encode()
    return encode_uvarint(len(body)) + body


def decode_frame(body: bytes) -> ProtoMessage:
    """Decode one frame body (type byte + payload, length prefix already
    stripped)."""
    if not body:
        raise ProtocolError("empty frame")
    cls = MESSAGE_TYPES.get(body[0])
    if cls is None:
        raise ProtocolError(f"unknown message type {body[0]}")
    try:
        return cls.decode(body[1:])
    except (EOFError, ValueError, UnicodeDecodeError) as exc:
        raise ProtocolError(
            f"malformed {cls.__name__} payload: {exc}") from exc


class FrameReader:
    """Reads framed messages from a binary stream, enforcing the frame cap
    before reading the body. EOF mid-frame surfaces as ``EOFError`` (the
    peer went away), anything else malformed as ``ProtocolError``.
    ``body_s`` holds the ``time.perf_counter()`` readings around the last
    body's read: from its decoded length prefix to its last byte, never
    the wait for the frame to begin."""

    def __init__(self, stream, max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES):
        self._rd = DelimitedReader(stream, max_size=max_frame_bytes)
        self.body_s = (0.0, 0.0)

    def read_body(self) -> bytes:
        """One frame's body, undecoded."""
        try:
            n = self._rd.read_size()
        except ValueError as exc:  # oversized frame / runaway varint
            raise ProtocolError(str(exc)) from exc
        start = time.perf_counter()
        body = self._rd.read_exact(n)
        self.body_s = (start, time.perf_counter())
        return body

    def read_msg(self) -> ProtoMessage:
        return decode_frame(self.read_body())


def pack_mask(mask: List[bool]) -> bytes:
    return np.packbits(np.asarray(mask, dtype=bool), bitorder="little").tobytes()


def unpack_mask(packed: bytes, lane_count: int) -> List[bool]:
    if len(packed) < (lane_count + 7) // 8:
        raise ProtocolError(
            f"mask too short: {len(packed)} bytes for {lane_count} lanes")
    bits = np.unpackbits(np.frombuffer(packed, dtype=np.uint8), count=lane_count,
                         bitorder="little")
    return bits.astype(bool).tolist()


def write_frame(stream: io.RawIOBase, msg: ProtoMessage) -> None:
    stream.write(encode_frame(msg))
    flush = getattr(stream, "flush", None)
    if flush is not None:
        flush()


def parse_addr(addr: str) -> Tuple[str, object]:
    """Parse ``unix:///path/to.sock`` or ``tcp://host:port`` into
    ``("unix", path)`` / ``("tcp", (host, port))``."""
    if addr.startswith("unix://"):
        path = addr[len("unix://"):]
        if not path:
            raise ValueError(f"empty unix socket path in {addr!r}")
        return "unix", path
    if addr.startswith("tcp://"):
        hostport = addr[len("tcp://"):]
        host, sep, port = hostport.rpartition(":")
        if not sep or not host:
            raise ValueError(f"tcp address needs host:port: {addr!r}")
        return "tcp", (host, int(port))
    raise ValueError(
        f"sidecar address must be unix:// or tcp://, got {addr!r}")


# --- the columnar VerifyRequest path ------------------------------------------


class VerifyColumns(NamedTuple):
    """A decoded VerifyRequest with its lanes as four columns: views over
    the frame body from the C walk, lists from the Python walk."""
    request_id: int
    curve: str
    tally: bool
    deadline_ms: int
    trace_ctx: bytes
    pks: lanes.Bytes
    msgs: lanes.Bytes
    sigs: lanes.Bytes
    powers: lanes.Powers


def _uvarint(buf: bytes, pos: int, end: int) -> Tuple[int, int]:
    """``decode_uvarint`` on ``buf[:end]``."""
    result = 0
    shift = 0
    while True:
        if pos >= end:
            raise EOFError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _skip(buf: bytes, pos: int, end: int, wt: int) -> int:
    """``protoio._skip_field`` on ``buf[:end]``."""
    if wt == 0:
        return _uvarint(buf, pos, end)[1]
    if wt == 1:
        return pos + 8
    if wt == 5:
        return pos + 4
    if wt == 2:
        n, pos = _uvarint(buf, pos, end)
        return pos + n
    raise ValueError(f"unsupported wire type {wt}")


def _walk_verify_request(buf: bytes, pos: int) -> VerifyColumns:
    # The generic decode, unrolled for VerifyRequest and Lane: a known
    # field is read by its declared type whatever its wire type, the last
    # of a repeated scalar wins, unknown fields are skipped by wire type,
    # and a Lane's fields are read within its own length. Single-byte
    # varints (tags, lengths below 128) take a shortcut.
    end = len(buf)
    request_id = deadline_ms = 0
    curve = ""
    tally = False
    trace_ctx = b""
    pks: List[bytes] = []
    msgs: List[bytes] = []
    sigs: List[bytes] = []
    powers: List[int] = []
    while pos < end:
        key = buf[pos]
        if key < 0x80:
            pos += 1
        else:
            key, pos = _uvarint(buf, pos, end)
        fn = key >> 3
        if fn == 5:
            if pos < end and buf[pos] < 0x80:
                n = buf[pos]
                pos += 1
            else:
                n, pos = _uvarint(buf, pos, end)
            lend = pos + n
            if lend > end:
                raise EOFError("truncated embedded message")
            pk = msg = sig = b""
            power = 0
            while pos < lend:
                k = buf[pos]
                if k < 0x80:
                    pos += 1
                else:
                    k, pos = _uvarint(buf, pos, lend)
                f = k >> 3
                if 1 <= f <= 3:
                    if pos < lend and buf[pos] < 0x80:
                        m = buf[pos]
                        pos += 1
                    else:
                        m, pos = _uvarint(buf, pos, lend)
                    if lend - pos < m:
                        raise EOFError("truncated bytes field")
                    value = buf[pos:pos + m]
                    pos += m
                    if f == 1:
                        pk = value
                    elif f == 2:
                        msg = value
                    else:
                        sig = value
                elif f == 4:
                    if pos < lend and buf[pos] < 0x80:
                        power = buf[pos]
                        pos += 1
                    else:
                        power, pos = _uvarint(buf, pos, lend)
                        if power >= 1 << 63:
                            power -= 1 << 64
                else:
                    pos = _skip(buf, pos, lend, k & 7)
            pks.append(pk)
            msgs.append(msg)
            sigs.append(sig)
            powers.append(power)
            pos = lend
        elif fn == 1:
            request_id, pos = _uvarint(buf, pos, end)
        elif fn == 2 or fn == 6:
            n, pos = _uvarint(buf, pos, end)
            if end - pos < n:
                raise EOFError(f"truncated {'string' if fn == 2 else 'bytes'} field")
            if fn == 2:
                curve = buf[pos:pos + n].decode("utf-8")
            else:
                trace_ctx = buf[pos:pos + n]
            pos += n
        elif fn == 3:
            v, pos = _uvarint(buf, pos, end)
            tally = bool(v)
        elif fn == 4:
            deadline_ms, pos = _uvarint(buf, pos, end)
        else:
            pos = _skip(buf, pos, end, key & 7)
    return VerifyColumns(request_id, curve, tally, deadline_ms, trace_ctx,
                         pks, msgs, sigs, powers)


def _native_columns(body: bytes):
    """The columns by the C walk (``native.walk_verify``), or None where the
    body needs the Python walk: each byte field a ``ByteColumn`` over the
    body, the powers an ``IntColumn``."""
    from tmtpu_torch import native  # the C build only where a body is decoded

    out = native.walk_verify(body)
    if out is None:
        return None
    request_id, c_lo, c_hi, tally, deadline_ms, t_lo, t_hi = out[-1].view(np.uint64).tolist()
    try:
        curve = body[c_lo:c_hi].decode("utf-8")
    except UnicodeDecodeError:
        return None
    cols = out[:-1].T.copy()  # [7, B]: each field's lo and hi contiguous
    buf = np.frombuffer(body, dtype=np.uint8)
    pks, msgs, sigs = (lanes.ByteColumn(buf, cols[i], cols[i + 1]) for i in (0, 2, 4))
    return VerifyColumns(request_id, curve, bool(tally), deadline_ms, body[t_lo:t_hi],
                         pks, msgs, sigs, lanes.IntColumn(cols[6]))


def decode_verify_walk(body: bytes) -> Tuple[VerifyColumns, str]:
    """``decode_verify_columns``, and which walk read the body: "native"
    (the C walk) or "python" (a body the C walk does not take)."""
    if not body or body[0] != VERIFY_REQUEST_TYPE:
        raise ProtocolError("not a VerifyRequest frame")
    columns = _native_columns(body)
    if columns is not None:
        return columns, "native"
    try:
        return _walk_verify_request(body, 1), "python"
    except (EOFError, ValueError, UnicodeDecodeError) as exc:
        raise ProtocolError(f"malformed VerifyRequest payload: {exc}") from exc


def decode_verify_columns(body: bytes) -> VerifyColumns:
    """A VerifyRequest frame body (type byte 3 + payload) as columns: the
    same fields, lanes and errors as ``decode_frame`` gives."""
    return decode_verify_walk(body)[0]


def columns_of(req: VerifyRequest) -> VerifyColumns:
    """The columns of a generically decoded VerifyRequest."""
    lanes = req.lanes
    return VerifyColumns(req.request_id, req.curve, req.tally, req.deadline_ms,
                         req.trace_ctx, [ln.pub_key for ln in lanes],
                         [ln.msg for ln in lanes], [ln.sig for ln in lanes],
                         [ln.power for ln in lanes])


_UV = [encode_uvarint(i) for i in range(1 << 14)]


def _uv(n: int) -> bytes:
    return _UV[n] if n < 16384 else encode_uvarint(n)


def encode_verify_frame(request_id: int, curve: str, tally: bool, deadline_ms: int,
                        pks, msgs, sigs, powers, trace_ctx: bytes = b"") -> bytes:
    """The frame ``encode_frame(VerifyRequest(...))`` gives for these lanes
    (key, message, signature and power columns), built without Lane
    objects."""
    head = VerifyRequest(request_id=request_id, curve=curve, tally=tally,
                         deadline_ms=deadline_ms).encode()
    parts = [bytes([VERIFY_REQUEST_TYPE]), head]
    for pk, m, s, p in zip(pks, msgs, sigs, powers):
        lane = b"".join((
            b"\x0a" + _uv(len(pk)) + pk if pk else b"",
            b"\x12" + _uv(len(m)) + m if m else b"",
            b"\x1a" + _uv(len(s)) + s if s else b"",
            b"\x20" + (_UV[p] if 0 < p < 16384 else encode_varint(p)) if p else b""))
        parts += (b"\x2a", _uv(len(lane)), lane)
    if trace_ctx:
        parts += (b"\x32", _uv(len(trace_ctx)), trace_ctx)
    body = b"".join(parts)
    return encode_uvarint(len(body)) + body
