"""Cross-client batch coalescing: many requests, one device dispatch. The
port's copy of ``tmtpu/sidecar/coalescer.py``, with requests carrying
their lanes as four columns (keys, messages, signatures, powers).

Requests from any number of connections enter per-curve queues; one
dispatcher thread, the only one that launches kernels, gathers them under
its own ``AdaptiveFlushScheduler`` (fed by request arrivals and dispatch
round trips) and hands one joint set of columns per curve to the verify
engine. Each request gets back its slice of the joint mask, its own
tally recomputed from that slice, and the dispatch's metadata (id, lanes,
distinct clients, traced requests).

- Whole requests only: a request's lanes never split across dispatches,
  so ``max_lanes_per_dispatch`` is a soft cap (gathering stops before the
  next whole request would pass it; one oversized request dispatches
  alone).
- The curve whose oldest request has waited longest goes first.
- Admission control: ``submit`` raises ``Overloaded`` when the request
  would push the queued lanes past ``max_queue_lanes``.
- A request past its deadline before dispatch is answered without lanes
  (``failure="expired"``). An engine exception, or a mask of the wrong
  length, answers every request of the dispatch with ``failure="engine"``
  and no mask.

The reference's metrics, timeline records, trace marks and mesh-dispatch
accounting are not ported.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

# the verify engine: (curve, pks, msgs, sigs, powers, tally) -> (mask, tallied)
VerifyFn = Callable[[str, list, list, list, list, bool], Tuple[List[bool], int]]


class Overloaded(Exception):
    """Admission control rejected the request; queues are full."""


class AdaptiveFlushScheduler:
    """The gather window, the port's copy of the reference's scheduler
    (``tmtpu/crypto/batch.py``). Two EWMAs: the lane arrival rate (from
    ``note_arrivals``) and the dispatch round trip (from
    ``note_dispatch``). The target batch is the lanes that arrive during
    one round trip, clamped to [min_lanes, max_lanes]; ``gather_wait_s``
    is how long to linger to fill it, at most ``max_wait_s``, and 0 until
    both EWMAs have samples. ``fixed_wait_s``, when set, replaces that
    answer with a fixed window, for runs that must coalesce a known set of
    clients into one dispatch."""

    def __init__(self):
        self._lock = threading.Lock()
        self._alpha = 0.2
        self._rate = 0.0          # lanes/s
        self._rtt = 0.0           # seconds per dispatch
        self._last_arrival: Optional[float] = None
        self.enabled = True
        self.min_lanes = 8        # the reference's _TPU_MIN_BATCH
        self.max_lanes = 4096
        self.max_wait_s = 0.008
        self.fixed_wait_s: Optional[float] = None

    def note_arrivals(self, n: int = 1) -> None:
        now = time.monotonic()
        with self._lock:
            last, self._last_arrival = self._last_arrival, now
            if last is None:
                return
            dt = now - last
            # arrivals more than ~1 s apart are an idle gap, not a rate
            if dt <= 0 or dt > 1.0:
                return
            inst = n / dt
            a = self._alpha
            self._rate = inst if self._rate <= 0 else (1 - a) * self._rate + a * inst

    def note_dispatch(self, lanes: int, seconds: float) -> None:
        if seconds <= 0:
            return
        # a first dispatch's one-time costs would poison the steady state
        seconds = min(seconds, 2.0)
        with self._lock:
            a = self._alpha
            self._rtt = seconds if self._rtt <= 0 else (1 - a) * self._rtt + a * seconds

    def snapshot(self) -> Dict:
        with self._lock:
            return {"rate_lanes_per_s": round(self._rate, 3),
                    "rtt_s": round(self._rtt, 6),
                    "enabled": self.enabled,
                    "target_lanes": self._target_locked()}

    def _target_locked(self) -> int:
        if not self.enabled or self._rtt <= 0 or self._rate <= 0:
            return self.min_lanes
        return int(max(self.min_lanes, min(self.max_lanes, self._rate * self._rtt)))

    def gather_wait_s(self, pending: int) -> float:
        """Seconds the dispatcher may linger to fill ``pending`` toward the
        target: 0.0 without samples, with the target met, or disabled;
        ``fixed_wait_s`` whenever it is set."""
        if self.fixed_wait_s is not None:
            return self.fixed_wait_s
        with self._lock:
            if not self.enabled or self._rtt <= 0 or self._rate <= 0:
                return 0.0
            target = self._target_locked()
            rate = self._rate
        if pending >= target:
            return 0.0
        return min((target - pending) / rate, self.max_wait_s)


class PendingRequest:
    """One client's verify request riding toward a joint dispatch."""

    __slots__ = ("client_id", "curve", "pks", "msgs", "sigs", "powers", "tally",
                 "deadline", "enqueued_at", "done", "mask", "tallied", "error",
                 "failure", "dispatch_id", "dispatch_lanes", "dispatch_clients",
                 "traced", "dispatch_traces")

    def __init__(self, client_id: str, curve: str, pks, msgs, sigs, powers,
                 tally: bool, deadline: Optional[float], traced: bool = False):
        self.client_id = client_id
        self.curve = curve
        self.pks, self.msgs, self.sigs, self.powers = pks, msgs, sigs, powers
        self.tally = tally
        self.deadline = deadline          # monotonic, None = no deadline
        self.enqueued_at = time.monotonic()
        self.done = threading.Event()
        self.mask: Optional[List[bool]] = None
        self.tallied = 0
        self.error = ""
        self.failure = ""          # "" | "expired" | "engine" | "stopped"
        self.dispatch_id = 0
        self.dispatch_lanes = 0
        self.dispatch_clients = 0
        # whether the request carried a valid trace context, and after
        # dispatch how many traced requests shared it
        self.traced = traced
        self.dispatch_traces = 0

    def __len__(self) -> int:
        return len(self.sigs)

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.done.wait(timeout)


class Coalescer:
    def __init__(self, verify_fn: VerifyFn, *,
                 max_queue_lanes: int = 65536,
                 max_lanes_per_dispatch: int = 40960,
                 scheduler: Optional[AdaptiveFlushScheduler] = None):
        self._verify_fn = verify_fn
        self._max_queue_lanes = max_queue_lanes
        self._max_lanes_per_dispatch = max_lanes_per_dispatch
        # the daemon's own scheduler: its arrivals are every client's
        self.scheduler = scheduler or AdaptiveFlushScheduler()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queues: Dict[str, List[PendingRequest]] = {}
        self._queued_lanes = 0
        self._inflight = 0            # batches cut but not yet answered
        self._dispatch_seq = 0
        self._running = False
        self._thread: Optional[threading.Thread] = None

    # --- lifecycle ---

    def start(self) -> None:
        with self._lock:
            if self._running:
                return
            self._running = True
        self._thread = threading.Thread(
            target=self._run, name="sidecar-coalescer", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        with self._cond:
            self._running = False
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        # fail whatever never dispatched so no client blocks forever
        with self._lock:
            leftovers = [r for q in self._queues.values() for r in q]
            self._queues.clear()
            self._queued_lanes = 0
        for req in leftovers:
            req.error = "coalescer stopped"
            req.failure = "stopped"
            req.done.set()

    # --- client side ---

    def submit(self, client_id: str, curve: str, pks, msgs, sigs, powers,
               tally: bool, deadline_s: Optional[float] = None,
               traced: bool = False) -> PendingRequest:
        """Enqueue one request's columns; returns a waitable
        ``PendingRequest``. Raises ``Overloaded`` when the queues are full
        (never queues part of a request)."""
        req = PendingRequest(
            client_id, curve, pks, msgs, sigs, powers, tally,
            None if deadline_s is None else time.monotonic() + deadline_s,
            traced=traced)
        n = len(req)
        with self._cond:
            if not self._running:
                raise Overloaded("coalescer not running")
            if self._queued_lanes + n > self._max_queue_lanes:
                raise Overloaded(
                    f"queue full: {self._queued_lanes} lanes queued, "
                    f"+{n} exceeds cap {self._max_queue_lanes}")
            self._queues.setdefault(curve, []).append(req)
            self._queued_lanes += n
            self._cond.notify_all()
        self.scheduler.note_arrivals(n)
        return req

    def queued_lanes(self) -> int:
        with self._lock:
            return self._queued_lanes

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until every queued request has dispatched and every cut
        batch has been answered, or the timeout passes (returns False).
        The dispatcher keeps running; shutdown calls drain() first (with
        admission closed upstream), then stop()."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._running and (self._queued_lanes > 0 or self._inflight > 0):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                # bounded wait: a wedged engine must not make drain hang
                self._cond.wait(timeout=min(remaining, 0.25))
            return self._queued_lanes == 0 and self._inflight == 0

    def snapshot(self) -> Dict:
        with self._lock:
            per_curve = {c: sum(len(r) for r in q) for c, q in self._queues.items() if q}
            return {"queued_lanes": self._queued_lanes,
                    "queued_by_curve": per_curve,
                    "inflight_batches": self._inflight,
                    "dispatches": self._dispatch_seq,
                    "scheduler": self.scheduler.snapshot()}

    # --- dispatcher ---

    def _pick_curve_locked(self) -> Optional[str]:
        """The curve whose oldest request has waited longest (FIFO across
        curves, so a busy ed25519 stream cannot starve a secp256k1
        trickle)."""
        best, best_t = None, None
        for curve, q in self._queues.items():
            if q and (best_t is None or q[0].enqueued_at < best_t):
                best, best_t = curve, q[0].enqueued_at
        return best

    def _run(self) -> None:
        while True:
            batch: List[PendingRequest] = []
            with self._cond:
                while self._running:
                    curve = self._pick_curve_locked()
                    if curve is None:
                        self._cond.wait(timeout=0.5)
                        continue
                    q = self._queues[curve]
                    lanes = sum(len(r) for r in q)
                    # linger only while the window says more arrivals are
                    # worth it and the oldest request has slack
                    wait = self.scheduler.gather_wait_s(lanes)
                    if lanes >= self._max_lanes_per_dispatch:
                        wait = 0.0
                    now = time.monotonic()
                    remaining = wait - (now - q[0].enqueued_at)
                    if q[0].deadline is not None:
                        remaining = min(remaining, q[0].deadline - now)
                    if remaining > 1e-4:
                        self._cond.wait(timeout=remaining)
                        continue
                    # whole requests up to the cap, always at least one
                    taken = 0
                    while q and (not batch or taken + len(q[0]) <= self._max_lanes_per_dispatch):
                        r = q.pop(0)
                        batch.append(r)
                        taken += len(r)
                    self._queued_lanes -= taken
                    self._inflight += 1
                    break
                if not self._running:
                    return
            if batch:
                try:
                    self._dispatch(batch[0].curve, batch)
                finally:
                    with self._cond:
                        self._inflight -= 1
                        self._cond.notify_all()

    def _dispatch(self, curve: str, batch: List[PendingRequest]) -> None:
        # expired requests are answered without spending device lanes
        now = time.monotonic()
        live: List[PendingRequest] = []
        for req in batch:
            if req.deadline is not None and now > req.deadline:
                req.error = "deadline expired before dispatch"
                req.failure = "expired"
                req.done.set()
            else:
                live.append(req)
        if not live:
            return
        with self._lock:
            self._dispatch_seq += 1
            dispatch_id = self._dispatch_seq
        pks, msgs, sigs, powers = [], [], [], []
        for req in live:
            pks += req.pks
            msgs += req.msgs
            sigs += req.sigs
            powers += req.powers
        clients = len({req.client_id for req in live})
        tally = any(req.tally for req in live)
        t0 = time.perf_counter()
        try:
            mask, _tallied = self._verify_fn(curve, pks, msgs, sigs, powers, tally)
        except Exception as exc:  # noqa: BLE001 - an engine failure must not
            # wedge clients: they get an error verdict, never a mask
            for req in live:
                req.error = f"verify engine failed: {exc}"
                req.failure = "engine"
                req.done.set()
            return
        self.scheduler.note_dispatch(len(sigs), time.perf_counter() - t0)
        traced = sum(req.traced for req in live)
        if len(mask) != len(sigs):
            for req in live:
                req.error = (f"verify engine returned {len(mask)} verdicts "
                             f"for {len(sigs)} lanes")
                req.failure = "engine"
                req.done.set()
            return
        off = 0
        for req in live:
            n = len(req)
            req.mask = [bool(v) for v in mask[off:off + n]]
            # each request's tally from its own slice, in Python ints: the
            # joint sum belongs to nobody; verify-only requests get 0
            req.tallied = (sum(itertools.compress(req.powers, req.mask))
                           if req.tally else 0)
            req.dispatch_id = dispatch_id
            req.dispatch_lanes = len(sigs)
            req.dispatch_clients = clients
            req.dispatch_traces = traced
            off += n
            req.done.set()
