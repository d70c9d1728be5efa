"""Per-height timeline journal: the port's copy of
``tmtpu/libs/timeline.py``, cut to the records the device path and the
sidecar daemon make.

A bounded ring of per-height event records (``TMTPU_TIMELINE_CAPACITY``
heights, default 128; at most 512 events a height, the rest counted as
overflow). The port's hooks have no height in scope, so, as in the
reference, they land on the timeline's current height, the highest one
recorded so far; before any height is recorded they are dropped:

- ``record_flush``: a batch-verify flush (``crypto/batch.py``,
  ``backend`` the device label) or a mesh dispatch
  (``gpu/mesh_dispatch.py``, ``backend="mesh"``);
- ``record_sigcache``: a flush that had cache hits or in-flush dedup;
- ``record_sidecar``: a joint dispatch of the daemon's coalescer
  (``role="server"``).

The reference's ``record_breaker`` is left out: the port has no breaker.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

_DEFAULT_CAPACITY = int(os.environ.get("TMTPU_TIMELINE_CAPACITY", "128"))

# events per height are capped so a flood cannot grow one record without
# bound; overflow counts, never blocks
_MAX_EVENTS_PER_HEIGHT = 512

EVENT_BATCH_FLUSH = "crypto.batch_flush"
EVENT_SIGCACHE = "crypto.sigcache"
EVENT_SIDECAR = "crypto.sidecar"


class Timeline:
    """Bounded per-height event journal. All methods are thread-safe."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY):
        self.capacity = max(1, capacity)
        self._heights: "OrderedDict[int, Dict]" = OrderedDict()
        self._lock = threading.Lock()
        self._current_height = 0
        self._dropped = 0
        self._last: Optional[Dict] = None  # most recent event overall

    def record(self, height: int, event: str, round: int = 0,
               **attrs) -> None:
        """Append one event to ``height``'s record; ``height <= 0`` is
        ignored (a caller that does not know the height yet)."""
        if height <= 0:
            return
        ev = {"event": event, "round": int(round), "t": time.time()}
        if attrs:
            ev.update(attrs)
        with self._lock:
            rec = self._heights.get(height)
            if rec is None:
                rec = {"height": height, "first_seen": ev["t"],
                       "events": [], "overflow": 0}
                self._heights[height] = rec
                while len(self._heights) > self.capacity:
                    self._heights.popitem(last=False)
                    self._dropped += 1
            if len(rec["events"]) >= _MAX_EVENTS_PER_HEIGHT:
                rec["overflow"] += 1
            else:
                rec["events"].append(ev)
            if height > self._current_height:
                self._current_height = height
            self._last = {"height": height, **ev}

    def record_flush(self, **attrs) -> None:
        """A batch-verify flush, on the current height."""
        self.record(self._current_height, EVENT_BATCH_FLUSH, **attrs)

    def record_sigcache(self, **attrs) -> None:
        """A flush's verify-once eliminations, on the current height."""
        self.record(self._current_height, EVENT_SIGCACHE, **attrs)

    def record_sidecar(self, **attrs) -> None:
        """A daemon's joint dispatch, on the current height."""
        self.record(self._current_height, EVENT_SIDECAR, **attrs)

    def current_height(self) -> int:
        with self._lock:
            return self._current_height

    def snapshot(self, height: Optional[int] = None,
                 last: int = 20) -> List[Dict]:
        """Per-height records, oldest first: ``height`` alone, or the most
        recent ``last`` heights."""
        with self._lock:
            if height is not None:
                rec = self._heights.get(height)
                recs = [rec] if rec is not None else []
            else:
                recs = list(self._heights.values())[-max(0, last):]
            # events are never mutated after append: a list copy suffices
            return [{"height": r["height"], "first_seen": r["first_seen"],
                     "overflow": r["overflow"],
                     "events": list(r["events"])} for r in recs]

    def last_event(self) -> Optional[Dict]:
        """The most recent event anywhere, with its age."""
        with self._lock:
            if self._last is None:
                return None
            out = dict(self._last)
        out["age_s"] = round(max(0.0, time.time() - out["t"]), 6)
        return out

    def summary(self) -> Dict:
        with self._lock:
            return {"heights": len(self._heights),
                    "current_height": self._current_height,
                    "capacity": self.capacity,
                    "dropped_heights": self._dropped}


DEFAULT = Timeline()


def record(height: int, event: str, round: int = 0, **attrs) -> None:
    DEFAULT.record(height, event, round=round, **attrs)


def record_flush(**attrs) -> None:
    DEFAULT.record_flush(**attrs)


def record_sigcache(**attrs) -> None:
    DEFAULT.record_sigcache(**attrs)


def record_sidecar(**attrs) -> None:
    DEFAULT.record_sidecar(**attrs)


def snapshot(height: Optional[int] = None, last: int = 20) -> List[Dict]:
    return DEFAULT.snapshot(height=height, last=last)


def last_event() -> Optional[Dict]:
    return DEFAULT.last_event()


def summary() -> Dict:
    return DEFAULT.summary()
