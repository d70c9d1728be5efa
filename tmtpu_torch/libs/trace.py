"""Span-based tracing for the device path: the port's copy of
``tmtpu/libs/trace.py``.

Every stage of a device flush records a Span into a process-wide,
thread-safe ring buffer, under the reference's span names:

    from tmtpu_torch.libs import trace

    with trace.span("ed25519.prepare", lanes=B):
        ...                      # nested spans record their parent

Spans nest per thread (a thread-local stack carries the current parent),
carry JSON-able attrs and cost about a microsecond each. The ring holds
the most recent ``capacity`` spans (default 8192, env
``TMTPU_TRACE_CAPACITY``); older spans are evicted and counted, never
blocking the hot path. ``snapshot()`` reads the ring, ``drain()`` reads
and clears it, ``summary()`` aggregates it by name; ``to_chrome_trace``
and ``to_jsonl`` export it.

``TraceContext`` is the cross-process context a node sends the sidecar
daemon (v2 VerifyRequest ``trace_ctx``): ``adopt`` decodes it strictly
(garbage is untraced, never an error) and ``mark`` records an instant
span tagged with it. ``record`` adds a completed span from two
``perf_counter`` readings, for a wait that starts on one thread and ends on
another.

Left out, since only a node uses them: height trace ids, outbound wire
contexts, sampling, the ``traced`` decorator, the thread's current
context and the clock anchor.
"""

from __future__ import annotations

import itertools
import json
import os
import struct
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

_DEFAULT_CAPACITY = int(os.environ.get("TMTPU_TRACE_CAPACITY", "8192"))

# -- trace context ------------------------------------------------------------

CTX_WIRE_VERSION = 1
CTX_MAX_WIRE_BYTES = 64          # hard cap; anything bigger is garbage
_CTX_ORIGIN_MAX = 40             # node ids are 40 hex chars
FLAG_SAMPLED = 0x01

# the causal-chain marks the daemon records (the reference's TRACE_MARKS
# has the node's too)
TRACE_MARKS = ("sidecar.dispatch",)


class TraceContext:
    """Compact cross-process trace context: ``trace_id`` is 16 lowercase
    hex chars (8 bytes on the wire), ``parent_span_id`` the sender's span
    id (0 = root), ``origin`` the node id that minted or forwarded it,
    ``flags`` bit 0 = sampled."""

    __slots__ = ("trace_id", "parent_span_id", "origin", "flags")

    def __init__(self, trace_id: str, parent_span_id: int = 0,
                 origin: str = "", flags: int = FLAG_SAMPLED):
        self.trace_id = trace_id
        self.parent_span_id = parent_span_id
        self.origin = origin
        self.flags = flags

    def encode(self) -> bytes:
        """Wire form: version(1) || trace_id(8) || parent_span_id(8, BE)
        || flags(1) || origin_len(1) || origin; fields are clamped, so it
        raises nothing."""
        try:
            tid = bytes.fromhex(self.trace_id)[:8]
        except ValueError:
            tid = b""
        tid = tid.ljust(8, b"\x00")
        origin = self.origin.encode("ascii", "replace")[:_CTX_ORIGIN_MAX]
        return (bytes([CTX_WIRE_VERSION]) + tid
                + struct.pack(">Q", self.parent_span_id & (2 ** 64 - 1))
                + bytes([self.flags & 0xFF, len(origin)]) + origin)

    @classmethod
    def decode(cls, raw: bytes) -> Optional["TraceContext"]:
        """Strict, total decode: truncated, oversized or garbage input
        returns None (untraced); a malformed context never crashes a
        receive path."""
        try:
            if (not raw or not isinstance(raw, (bytes, bytearray))
                    or len(raw) > CTX_MAX_WIRE_BYTES or len(raw) < 19
                    or raw[0] != CTX_WIRE_VERSION):
                return None
            olen = raw[18]
            if olen > _CTX_ORIGIN_MAX or len(raw) != 19 + olen:
                return None
            origin = raw[19:19 + olen].decode("ascii")
            return cls(raw[1:9].hex(), struct.unpack(">Q", raw[9:17])[0],
                       origin, raw[17])
        except Exception:  # noqa: BLE001 - garbage is untraced, never an error
            return None

    def to_dict(self) -> Dict:
        return {"trace": self.trace_id, "parent": self.parent_span_id,
                "origin": self.origin, "flags": self.flags}

    def __repr__(self):
        return (f"TraceContext({self.trace_id}, parent={self.parent_span_id},"
                f" origin={self.origin!r}, flags={self.flags:#x})")


class Span:
    """One completed (or in-flight) timed region. Times are
    ``time.perf_counter()`` seconds, comparable across spans in-process."""

    __slots__ = ("name", "span_id", "parent_id", "thread_id", "thread_name",
                 "start_s", "end_s", "attrs", "trace_id", "ctx_parent",
                 "origin")

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 thread_id: int, thread_name: str, start_s: float,
                 attrs: Dict):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.thread_id = thread_id
        self.thread_name = thread_name
        self.start_s = start_s
        self.end_s: Optional[float] = None
        self.attrs = attrs
        # cross-process causal identity (None/0/"": an untraced span)
        self.trace_id: Optional[str] = None
        self.ctx_parent: int = 0
        self.origin: str = ""

    @property
    def duration_s(self) -> float:
        if self.end_s is None:
            return 0.0
        return max(0.0, self.end_s - self.start_s)

    def set(self, **attrs) -> None:
        """Attach attrs mid-span (e.g. a number known only later)."""
        self.attrs.update(attrs)

    def to_dict(self) -> Dict:
        d = {
            "name": self.name, "id": self.span_id,
            "parent": self.parent_id, "tid": self.thread_id,
            "thread": self.thread_name,
            "start_s": round(self.start_s, 9),
            "dur_s": round(self.duration_s, 9),
            "attrs": self.attrs,
        }
        if self.trace_id:
            d["trace"] = self.trace_id
            d["ctx_parent"] = self.ctx_parent
            d["origin"] = self.origin
        return d

    def __repr__(self):
        return (f"Span({self.name!r}, {self.duration_s * 1e3:.3f}ms, "
                f"attrs={self.attrs})")


class Tracer:
    """Thread-safe ring buffer of completed spans with per-thread parent
    nesting. One process-wide instance (``DEFAULT``) backs the module-level
    API; tests may construct their own."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY):
        self._buf: deque = deque(maxlen=max(1, capacity))
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self._enabled = True
        self._dropped = 0

    def set_enabled(self, flag: bool) -> None:
        self._enabled = bool(flag)

    def enabled(self) -> bool:
        return self._enabled

    @property
    def dropped(self) -> int:
        """Spans evicted by the ring since the last drain()."""
        return self._dropped

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _append(self, sp: Span) -> None:
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self._dropped += 1
            self._buf.append(sp)

    @contextmanager
    def span(self, name: str, **attrs):
        """Record a timed region; yields the Span so callers can ``.set``
        attrs found mid-region. Exceptions propagate (the span still
        records, flagged ``error=True``)."""
        if not self._enabled:
            yield _NULL_SPAN
            return
        t = threading.current_thread()
        stack = self._stack()
        sp = Span(name, next(self._ids),
                  stack[-1].span_id if stack else None,
                  t.ident or 0, t.name, time.perf_counter(), dict(attrs))
        stack.append(sp)
        try:
            yield sp
        except BaseException:
            sp.attrs["error"] = True
            raise
        finally:
            sp.end_s = time.perf_counter()
            stack.pop()
            self._append(sp)

    def mark(self, name: str, ctx: Optional[TraceContext] = None,
             **attrs) -> Optional[Span]:
        """Record an instant (zero-duration) span tagged with ``ctx``."""
        if not self._enabled:
            return None
        t = threading.current_thread()
        now = time.perf_counter()
        sp = Span(name, next(self._ids), None, t.ident or 0, t.name,
                  now, dict(attrs))
        sp.end_s = now
        if ctx is not None:
            sp.trace_id = ctx.trace_id
            sp.ctx_parent = ctx.parent_span_id
            sp.origin = ctx.origin
        self._append(sp)
        return sp

    def record(self, name: str, start_s: float, end_s: float, **attrs) -> None:
        """Record a completed span from two ``time.perf_counter()``
        readings taken elsewhere, nested on the calling thread: for a wait
        whose two ends lie on different threads."""
        if not self._enabled:
            return
        t = threading.current_thread()
        stack = self._stack()
        sp = Span(name, next(self._ids), stack[-1].span_id if stack else None,
                  t.ident or 0, t.name, start_s, dict(attrs))
        sp.end_s = end_s
        self._append(sp)

    def snapshot(self) -> List[Span]:
        """Current ring contents, oldest first, without clearing."""
        with self._lock:
            return list(self._buf)

    def drain(self) -> List[Span]:
        """Return and clear the ring (also resets the dropped counter)."""
        with self._lock:
            out = list(self._buf)
            self._buf.clear()
            self._dropped = 0
            return out

    def summary(self) -> Dict:
        """Aggregate per span name: {name: {count, total_s, max_s}} plus
        the ring's bookkeeping."""
        spans = self.snapshot()
        agg: Dict[str, Dict] = {}
        for sp in spans:
            a = agg.setdefault(sp.name,
                               {"count": 0, "total_s": 0.0, "max_s": 0.0})
            a["count"] += 1
            d = sp.duration_s
            a["total_s"] += d
            if d > a["max_s"]:
                a["max_s"] = d
        for a in agg.values():
            a["total_s"] = round(a["total_s"], 6)
            a["max_s"] = round(a["max_s"], 6)
        return {"spans": agg, "buffered": len(spans),
                "dropped": self._dropped,
                "capacity": self._buf.maxlen, "enabled": self._enabled}


class _NullSpan:
    """Yielded while tracing is disabled: absorbs .set() calls."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()


# -- export formats -----------------------------------------------------------


def to_chrome_trace(spans: List[Span]) -> Dict:
    """Chrome trace-event format (chrome://tracing, Perfetto): complete "X"
    events, µs timestamps on the shared perf_counter clock, one row per
    thread; span ids and parents ride in args."""
    events = []
    for sp in spans:
        args = dict(sp.attrs, span_id=sp.span_id, parent_id=sp.parent_id)
        if sp.trace_id:
            args["trace"] = sp.trace_id
            args["ctx_parent"] = sp.ctx_parent
            args["origin"] = sp.origin
        events.append({
            "name": sp.name, "ph": "X", "pid": os.getpid(),
            "tid": sp.thread_id, "ts": sp.start_s * 1e6,
            "dur": sp.duration_s * 1e6,
            "args": args,
        })
    seen = set()
    for sp in spans:
        if sp.thread_id not in seen:
            seen.add(sp.thread_id)
            events.append({
                "name": "thread_name", "ph": "M", "pid": os.getpid(),
                "tid": sp.thread_id,
                "args": {"name": sp.thread_name},
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def to_jsonl(spans: List[Span]) -> str:
    """One JSON object per line; a trailing newline when non-empty, so
    concatenated drains stay line-delimited."""
    if not spans:
        return ""
    return "\n".join(json.dumps(sp.to_dict()) for sp in spans) + "\n"


# -- process-wide tracer and module-level API ---------------------------------

DEFAULT = Tracer()


def span(name: str, **attrs):
    return DEFAULT.span(name, **attrs)


def mark(name: str, ctx: Optional[TraceContext] = None, **attrs):
    return DEFAULT.mark(name, ctx=ctx, **attrs)


def record(name: str, start_s: float, end_s: float, **attrs) -> None:
    DEFAULT.record(name, start_s, end_s, **attrs)


def adopt(raw: bytes) -> Optional[TraceContext]:
    """Decode a received wire context; None (never an exception) for an
    absent or garbage one."""
    if not raw:
        return None
    return TraceContext.decode(raw)


def snapshot() -> List[Span]:
    return DEFAULT.snapshot()


def drain() -> List[Span]:
    return DEFAULT.drain()


def summary() -> Dict:
    return DEFAULT.summary()


def set_enabled(flag: bool) -> None:
    DEFAULT.set_enabled(flag)


def enabled() -> bool:
    return DEFAULT.enabled()
