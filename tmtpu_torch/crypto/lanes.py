"""A flush's lane columns as one byte buffer with per-lane offsets.

The sidecar daemon receives a VerifyRequest's lanes as one frame body;
the C walk (``native.walk_verify``) finds where each key, message and
signature lies in it. ``ByteColumn`` keeps exactly that: a contiguous
uint8 buffer and int64 ``lo`` / ``hi`` offsets, lane i being
``buf[lo[i]:hi[i]]``. The decode, the coalescer's join, the signature
cache's resolve and the host preps pass columns on and hand the C entries
(buffer, lo, hi) as they are, so no per-lane Python object is made
between the frame and the kernel's plane.

A column still reads as a sequence of ``bytes``: ``len``, an integer index
and iteration give ``bytes``, a slice and ``take`` give another column
over the same buffer, and it compares equal to a list of the same byte
strings. ``IntColumn`` does the same for the powers, over an int64 array;
a power past int64 (only ``BatchVerifier.add`` can bring one) keeps the
powers a list of Python ints. Sums of powers (``tally``) are exact Python
ints however large.

Callers holding lists convert once at the boundary: ``byte_column`` joins
a list of byte strings into one buffer, ``power_column`` packs ints into
an ``IntColumn`` where they fit.
"""

from __future__ import annotations

import itertools
from typing import List, Sequence, Union

import numpy as np

_EMPTY = np.zeros(1, dtype=np.uint8)  # a valid pointer for an empty buffer


class ByteColumn:
    """Byte strings as [lo, hi) int64 offsets into one uint8 buffer."""

    __slots__ = ("buf", "lo", "hi")

    def __init__(self, buf: np.ndarray, lo: np.ndarray, hi: np.ndarray):
        self.buf = buf
        self.lo = lo
        self.hi = hi

    @classmethod
    def join(cls, parts) -> "ByteColumn":
        """Byte strings (any bytes-like) end to end in one new buffer."""
        lens = np.fromiter(map(len, parts), dtype=np.int64, count=len(parts))
        hi = np.cumsum(lens)
        blob = b"".join(parts)
        return cls(np.frombuffer(blob, dtype=np.uint8) if blob else _EMPTY, hi - lens, hi)

    def lengths(self) -> np.ndarray:
        return self.hi - self.lo

    def take(self, idx) -> "ByteColumn":
        """The lanes at positions ``idx`` (an index array), over the same
        buffer."""
        return ByteColumn(self.buf, self.lo[idx], self.hi[idx])

    def __len__(self) -> int:
        return len(self.lo)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return ByteColumn(self.buf, self.lo[i], self.hi[i])
        return self.buf[self.lo[i]:self.hi[i]].tobytes()

    def __iter__(self):
        buf = self.buf
        return (buf[a:b].tobytes() for a, b in zip(self.lo.tolist(), self.hi.tolist()))

    def __eq__(self, other):
        if not isinstance(other, (ByteColumn, list, tuple)):
            return NotImplemented
        return len(self) == len(other) and list(self) == list(other)

    __hash__ = None

    def __repr__(self) -> str:
        return f"ByteColumn({list(self)!r})"


class IntColumn:
    """Integers that fit int64, as one int64 array."""

    __slots__ = ("values",)

    def __init__(self, values: np.ndarray):
        self.values = values

    def take(self, idx) -> "IntColumn":
        return IntColumn(self.values[idx])

    def tolist(self) -> List[int]:
        return self.values.tolist()

    def __len__(self) -> int:
        return len(self.values)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return IntColumn(self.values[i])
        return int(self.values[i])

    def __iter__(self):
        return iter(self.values.tolist())

    def __eq__(self, other):
        if not isinstance(other, (IntColumn, list, tuple)):
            return NotImplemented
        return len(self) == len(other) and self.tolist() == list(other)

    __hash__ = None

    def __repr__(self) -> str:
        return f"IntColumn({self.tolist()!r})"


Bytes = Union[ByteColumn, Sequence[bytes]]
Powers = Union[IntColumn, List[int]]


def byte_column(parts: Bytes) -> ByteColumn:
    """``parts`` as a column: a column as it is, a sequence joined once."""
    return parts if isinstance(parts, ByteColumn) else ByteColumn.join(parts)


def power_column(powers) -> Powers:
    """``powers`` as an ``IntColumn`` where every value fits int64, else
    as a list of Python ints."""
    if isinstance(powers, IntColumn):
        return powers
    try:
        return IntColumn(np.fromiter(powers, dtype=np.int64, count=len(powers)))
    except OverflowError:
        return [int(p) for p in powers]


def take(col, idx):
    """The lanes of any column (a column or a list) at positions ``idx``."""
    if isinstance(col, (ByteColumn, IntColumn)):
        return col.take(np.asarray(idx, dtype=np.int64))
    return [col[i] for i in idx]


def tally(powers: Powers, mask) -> int:
    """The exact sum of the powers where ``mask`` (bool, one a lane) is
    set. An ``IntColumn`` is summed as 32-bit halves in int64 (exact below
    2^31 lanes) and recombined as a Python int."""
    if isinstance(powers, IntColumn):
        keep = powers.values[np.asarray(mask, dtype=bool)]
        return int((keep & 0xFFFFFFFF).sum()) + (int((keep >> 32).sum()) << 32)
    return sum(itertools.compress(powers, mask))


def concat_bytes(fields) -> List[ByteColumn]:
    """Several requests' byte columns joined field by field: ``fields`` is
    one sequence of columns per field (say every request's keys, then
    every request's messages). Each distinct buffer is copied once into one
    new buffer and the offsets are rebased, so every returned column reads
    that buffer."""
    fields = [[byte_column(c) for c in cols] for cols in fields]
    base, bufs, at = {}, [], 0
    for col in itertools.chain.from_iterable(fields):
        if id(col.buf) not in base:
            base[id(col.buf)] = at
            bufs.append(col.buf)
            at += len(col.buf)
    joint = np.concatenate(bufs) if bufs else _EMPTY
    none = np.zeros(0, dtype=np.int64)
    return [ByteColumn(joint,
                       np.concatenate([none] + [c.lo + base[id(c.buf)] for c in cols]),
                       np.concatenate([none] + [c.hi + base[id(c.buf)] for c in cols]))
            for cols in fields]


def concat_powers(cols) -> Powers:
    """Several requests' powers end to end."""
    if all(isinstance(c, IntColumn) for c in cols):
        return IntColumn(np.concatenate([np.zeros(0, dtype=np.int64)]
                                        + [c.values for c in cols]))
    return [int(p) for c in cols for p in c]
