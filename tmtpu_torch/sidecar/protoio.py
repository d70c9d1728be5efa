"""Protobuf (proto3) wire primitives for the sidecar codec: the port's own
copy of what ``tmtpu/libs/protoio.py`` gives the reference's sidecar
protocol (varints, field writers, the varint-delimited reader and the
declarative ``ProtoMessage``), with the same bytes out and the same
values, and errors, in:

- scalar fields with proto3 zero values are omitted;
- fields are emitted in ascending field-number order;
- negative varints use 10-byte two's-complement encoding;
- decoding skips unknown fields by wire type, and reads a known field by
  its declared type whatever wire type its tag carries.

The sidecar's messages use the varint scalars, bytes, strings and repeated
fields of those and of embedded messages; the reference's other specs
(fixed64, double, non-nullable messages) have no use here and are left
out.
"""

from __future__ import annotations

import io
from typing import List, Tuple

WIRE_VARINT = 0
WIRE_FIXED64 = 1
WIRE_BYTES = 2
WIRE_FIXED32 = 5


def encode_uvarint(value: int) -> bytes:
    if value < 0:
        raise ValueError("uvarint cannot be negative")
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def encode_varint(value: int) -> bytes:
    """Signed varint (two's complement, as protobuf int32/int64)."""
    if value < 0:
        value += 1 << 64
    return encode_uvarint(value)


def decode_uvarint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise EOFError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    v, pos = decode_uvarint(buf, pos)
    if v >= 1 << 63:
        v -= 1 << 64
    return v, pos


def tag(field_number: int, wire_type: int) -> bytes:
    return encode_uvarint((field_number << 3) | wire_type)


def write_varint_field(w: io.BytesIO, fn: int, value: int) -> None:
    w.write(tag(fn, WIRE_VARINT))
    w.write(encode_varint(value))


def write_bytes_field(w: io.BytesIO, fn: int, value: bytes) -> None:
    w.write(tag(fn, WIRE_BYTES))
    w.write(encode_uvarint(len(value)))
    w.write(value)


class DelimitedReader:
    """Reads uvarint-length-prefixed messages from a binary stream."""

    def __init__(self, stream, max_size: int = 64 * 1024 * 1024):
        self._stream = stream
        self._max = max_size

    def read_msg(self) -> bytes:
        return self.read_exact(self.read_size())

    def read_size(self) -> int:
        """The next message's length prefix, held to the cap."""
        n = self._read_uvarint()
        if n > self._max:
            raise ValueError(f"message too large: {n}")
        return n

    def read_exact(self, n: int) -> bytes:
        """The next ``n`` bytes: a message's body once its prefix is read."""
        data = self._stream.read(n)
        if len(data) != n:
            raise EOFError("truncated message body")
        return data

    def _read_uvarint(self) -> int:
        result = 0
        shift = 0
        while True:
            b = self._stream.read(1)
            if not b:
                raise EOFError("eof reading varint")
            result |= (b[0] & 0x7F) << shift
            if not b[0] & 0x80:
                return result
            shift += 7
            if shift > 70:
                raise ValueError("varint too long")


# Each message class declares FIELDS as a list of (field_number, attr_name,
# type_spec); type specs:
#   "int32" "int64" "uint32" "uint64" "bool" "enum"  - varint scalars
#   "bytes" "string"                                 - length-delimited
#   ("msg", cls)        - nullable embedded message (omit when None)
#   ("rep", spec)       - repeated field of any of the above
# Decoding tolerates unknown fields (skips them), as protobuf requires.


class ProtoMessage:
    FIELDS: List[tuple] = []

    def __init__(self, **kwargs):
        names = {f[1] for f in self.FIELDS}
        for _, name, spec in self.FIELDS:
            setattr(self, name, _default_for(spec))
        for k, v in kwargs.items():
            if k not in names:
                raise TypeError(f"{type(self).__name__} has no field {k!r}")
            setattr(self, k, v)

    def encode(self) -> bytes:
        w = io.BytesIO()
        for fn, name, spec in self.FIELDS:
            _encode_field(w, fn, spec, getattr(self, name))
        return w.getvalue()

    @classmethod
    def decode(cls, buf: bytes):
        msg = cls()
        pos = 0
        by_fn = {f[0]: f for f in cls.FIELDS}
        while pos < len(buf):
            key, pos = decode_uvarint(buf, pos)
            fn, wt = key >> 3, key & 7
            fld = by_fn.get(fn)
            if fld is None:
                pos = _skip_field(buf, pos, wt)
                continue
            _, name, spec = fld
            value, pos = _decode_field(buf, pos, wt, spec)
            if isinstance(spec, tuple) and spec[0] == "rep":
                getattr(msg, name).append(value)
            else:
                setattr(msg, name, value)
        return msg

    def __eq__(self, other):
        return type(self) is type(other) and all(
            getattr(self, f[1]) == getattr(other, f[1]) for f in self.FIELDS
        )

    def __repr__(self):
        parts = ", ".join(
            f"{f[1]}={getattr(self, f[1])!r}" for f in self.FIELDS
        )
        return f"{type(self).__name__}({parts})"


def _default_for(spec):
    if isinstance(spec, tuple):
        return [] if spec[0] == "rep" else None
    if spec == "bytes":
        return b""
    if spec == "string":
        return ""
    if spec == "bool":
        return False
    return 0


def _encode_field(w, fn, spec, value):
    if isinstance(spec, tuple):
        kind = spec[0]
        if kind == "rep":
            for item in value:
                _encode_single(w, fn, spec[1], item, always=True)
            return
        if kind == "msg":
            if value is not None:
                write_bytes_field(w, fn, value.encode())
            return
        raise ValueError(f"bad spec {spec}")
    _encode_single(w, fn, spec, value, always=False)


def _encode_single(w, fn, spec, value, always):
    if isinstance(spec, tuple):
        # repeated message element
        if spec[0] == "msg":
            write_bytes_field(w, fn, value.encode())
            return
        raise ValueError(f"bad repeated spec {spec}")
    if spec in ("int32", "int64", "enum"):
        if value or always:
            write_varint_field(w, fn, value)
    elif spec in ("uint32", "uint64"):
        if value or always:
            w.write(tag(fn, WIRE_VARINT))
            w.write(encode_uvarint(value))
    elif spec == "bool":
        if value or always:
            write_varint_field(w, fn, 1 if value else 0)
    elif spec == "bytes":
        if value or always:
            write_bytes_field(w, fn, bytes(value))
    elif spec == "string":
        if value or always:
            write_bytes_field(w, fn, value.encode("utf-8"))
    else:
        raise ValueError(f"unknown field spec {spec!r}")


def _skip_field(buf, pos, wt):
    if wt == WIRE_VARINT:
        _, pos = decode_uvarint(buf, pos)
        return pos
    if wt == WIRE_FIXED64:
        return pos + 8
    if wt == WIRE_FIXED32:
        return pos + 4
    if wt == WIRE_BYTES:
        n, pos = decode_uvarint(buf, pos)
        return pos + n
    raise ValueError(f"unsupported wire type {wt}")


def _decode_field(buf, pos, wt, spec):
    if isinstance(spec, tuple):
        if spec[0] == "rep":
            return _decode_field(buf, pos, wt, spec[1])
        if spec[0] == "msg":
            n, pos = decode_uvarint(buf, pos)
            sub = buf[pos : pos + n]
            if len(sub) != n:
                raise EOFError("truncated embedded message")
            return spec[1].decode(sub), pos + n
        raise ValueError(f"bad spec {spec}")
    if spec in ("int32", "int64", "enum"):
        return decode_varint(buf, pos)
    if spec in ("uint32", "uint64"):
        return decode_uvarint(buf, pos)
    if spec == "bool":
        v, pos = decode_uvarint(buf, pos)
        return bool(v), pos
    if spec == "bytes":
        n, pos = decode_uvarint(buf, pos)
        if len(buf) - pos < n:
            raise EOFError("truncated bytes field")
        return buf[pos : pos + n], pos + n
    if spec == "string":
        n, pos = decode_uvarint(buf, pos)
        if len(buf) - pos < n:
            raise EOFError("truncated string field")
        return buf[pos : pos + n].decode("utf-8"), pos + n
    raise ValueError(f"unknown field spec {spec!r}")
