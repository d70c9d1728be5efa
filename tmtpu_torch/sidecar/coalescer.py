"""Cross-client batch coalescing: many requests, one device dispatch. The
port's copy of ``tmtpu/sidecar/coalescer.py``, with requests carrying
their lanes as four columns (keys, messages, signatures, powers; views
over the frame body, ``crypto/lanes.py``, or lists).

Requests from any number of connections enter per-curve queues; one
dispatcher thread, the only one that launches kernels, gathers them under
its own ``AdaptiveFlushScheduler`` (fed by request arrivals and dispatch
round trips) and hands one joint set of columns per curve to the verify
engine. Each request gets back its slice of the joint mask, its own
tally summed from that slice, and the dispatch's metadata (id, lanes,
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

- Engine failures in a row (``engine_failures()``, with the last one's
  text) feed the daemon's health signal; a dispatch that answers resets
  the count.

The reference's ``sidecar_server_*`` metrics are kept in ``metrics``
(``sidecar/metrics.py``). Each joint dispatch also records one
``sidecar.dispatch`` trace mark per distinct trace id among its requests'
decoded contexts; the scheduler's ``target_lanes`` sets
``crypto_flush_target_lanes``.

Requests are stamped, ordered and held to their deadlines on
``time.perf_counter()``, the clock of the spans. The dispatcher records
each request's ``coalescer.queue_wait``, from ``submit``'s enqueue to the
cut of its batch (``client``, ``request_id``, ``lanes``, ``dispatch_id``,
0 for a request that expired, and ``linger_ms``, the part of the wait the
gather window chose to linger), and a ``coalescer.dispatch`` span over the
column join, the engine (the flush's span tree nests under it), the
per-request masks and tallies and the wake-ups (``dispatch_id``,
``lanes``, ``requests``, ``clients``). A request's ``done_at`` stamps its
wake-up, so the thread that waits on it can time the handoff.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from tmtpu_torch.crypto import lanes
from tmtpu_torch.libs import metrics as lib_metrics
from tmtpu_torch.libs import trace
from tmtpu_torch.sidecar.metrics import SidecarMetrics

# the verify engine: (curve, pks, msgs, sigs, powers, tally) -> the joint
# mask; each request's tally is summed here from its own slice
VerifyFn = Callable[[str, lanes.Bytes, lanes.Bytes, lanes.Bytes, lanes.Powers, bool],
                    List[bool]]


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

    def target_lanes(self) -> int:
        """The target batch, also set on ``crypto_flush_target_lanes``."""
        with self._lock:
            t = self._target_locked()
        lib_metrics.crypto_flush_target_lanes.set(t)
        return t

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

    __slots__ = ("client_id", "request_id", "curve", "pks", "msgs", "sigs", "powers",
                 "tally", "deadline", "enqueued_at", "done", "done_at",
                 "mask", "tallied", "error", "failure", "dispatch_id", "dispatch_lanes",
                 "dispatch_clients", "trace_ctx", "dispatch_traces")

    def __init__(self, client_id: str, curve: str, pks, msgs, sigs, powers,
                 tally: bool, deadline: Optional[float],
                 trace_ctx: Optional[trace.TraceContext] = None, request_id: int = 0):
        self.client_id = client_id
        self.request_id = request_id
        self.curve = curve
        self.pks, self.msgs, self.sigs, self.powers = pks, msgs, sigs, powers
        self.tally = tally
        self.deadline = deadline          # perf_counter, None = no deadline
        self.enqueued_at = time.perf_counter()
        self.done = threading.Event()
        self.done_at = 0.0                # perf_counter at finish()
        self.mask: Optional[List[bool]] = None
        self.tallied = 0
        self.error = ""
        self.failure = ""          # "" | "expired" | "engine" | "stopped"
        self.dispatch_id = 0
        self.dispatch_lanes = 0
        self.dispatch_clients = 0
        # the request's decoded trace context (None: untraced), and after
        # dispatch how many traced requests shared it
        self.trace_ctx = trace_ctx
        self.dispatch_traces = 0

    def __len__(self) -> int:
        return len(self.sigs)

    def finish(self) -> None:
        """Wake the waiter, stamping when."""
        self.done_at = time.perf_counter()
        self.done.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.done.wait(timeout)


class Coalescer:
    def __init__(self, verify_fn: VerifyFn, *,
                 max_queue_lanes: int = 65536,
                 max_lanes_per_dispatch: int = 40960,
                 scheduler: Optional[AdaptiveFlushScheduler] = None,
                 metrics: Optional[SidecarMetrics] = None):
        self._verify_fn = verify_fn
        self.metrics = metrics or SidecarMetrics()
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
        self._dispatched_requests = 0
        self._dispatches_by_curve: Dict[str, int] = {}
        self._dispatched_lanes = 0
        self._engine_failures = 0     # in a row; a dispatch that answers resets it
        self._last_engine_error = ""
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
            req.finish()

    # --- client side ---

    def submit(self, client_id: str, curve: str, pks, msgs, sigs, powers,
               tally: bool, deadline_s: Optional[float] = None,
               trace_ctx: Optional[trace.TraceContext] = None,
               request_id: int = 0) -> PendingRequest:
        """Enqueue one request's columns; returns a waitable
        ``PendingRequest``. Raises ``Overloaded`` when the queues are full
        (never queues part of a request). ``trace_ctx`` tags the joint
        dispatch the request rides; ``request_id`` (the wire's) tags its
        spans."""
        req = PendingRequest(
            client_id, curve, pks, msgs, sigs, powers, tally,
            None if deadline_s is None else time.perf_counter() + deadline_s,
            trace_ctx=trace_ctx, request_id=request_id)
        n = len(req)
        with self._cond:
            if not self._running:
                raise Overloaded("coalescer not running")
            if self._queued_lanes + n > self._max_queue_lanes:
                self.metrics.overloads.inc()
                raise Overloaded(
                    f"queue full: {self._queued_lanes} lanes queued, "
                    f"+{n} exceeds cap {self._max_queue_lanes}")
            self._queues.setdefault(curve, []).append(req)
            self._queued_lanes += n
            self.metrics.queue_lanes.set(self._queued_lanes)
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
                    "dispatches_by_curve": dict(self._dispatches_by_curve),
                    "dispatched_requests": self._dispatched_requests,
                    "dispatched_lanes": self._dispatched_lanes,
                    "scheduler": self.scheduler.snapshot()}

    def engine_failures(self) -> Tuple[int, str]:
        """Engine failures since the last dispatch that answered, and the
        last failure's text."""
        with self._lock:
            return self._engine_failures, self._last_engine_error

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
            linger_from = None  # perf_counter when the window began to linger
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
                    now = time.perf_counter()
                    remaining = wait - (now - q[0].enqueued_at)
                    if q[0].deadline is not None:
                        remaining = min(remaining, q[0].deadline - now)
                    if remaining > 1e-4:
                        if linger_from is None:
                            linger_from = now
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
                    self.metrics.queue_lanes.set(self._queued_lanes)
                    cut = time.perf_counter()
                    break
                if not self._running:
                    return
            if batch:
                try:
                    self._dispatch(batch[0].curve, batch, cut, linger_from)
                finally:
                    with self._cond:
                        self._inflight -= 1
                        self._cond.notify_all()

    def _engine_failed(self, live: List[PendingRequest], error: str) -> None:
        with self._lock:
            self._engine_failures += 1
            self._last_engine_error = error
        for req in live:
            req.error = error
            req.failure = "engine"
            req.finish()

    def _dispatch(self, curve: str, batch: List[PendingRequest], cut: float,
                  linger_from: Optional[float]) -> None:
        """Answer the expired requests of a batch cut at ``cut``
        (perf_counter), record every request's queue wait, and verify the
        rest in one joint dispatch."""
        # expired requests are answered without spending device lanes
        now = time.perf_counter()
        live: List[PendingRequest] = []
        for req in batch:
            if req.deadline is not None and now > req.deadline:
                req.error = "deadline expired before dispatch"
                req.failure = "expired"
                req.finish()
            else:
                live.append(req)
        dispatch_id = 0
        if live:
            with self._lock:
                self._dispatch_seq += 1
                dispatch_id = self._dispatch_seq
        for req in batch:
            linger = (0.0 if linger_from is None
                      else max(0.0, cut - max(linger_from, req.enqueued_at)))
            trace.record("coalescer.queue_wait", req.enqueued_at, cut,
                         client=req.client_id, request_id=req.request_id, lanes=len(req),
                         dispatch_id=0 if req.failure else dispatch_id,
                         linger_ms=linger * 1e3)
        if not live:
            return
        clients = len({req.client_id for req in live})
        with trace.span("coalescer.dispatch", dispatch_id=dispatch_id,
                        lanes=sum(len(req) for req in live), requests=len(live),
                        clients=clients):
            self._verify_joint(curve, live, dispatch_id, clients)

    def _verify_joint(self, curve: str, live: List[PendingRequest], dispatch_id: int,
                      clients: int) -> None:
        """One engine call over the joined columns of ``live``, then each
        request's slice of the mask and its tally, and its wake-up. A lone
        request's columns go to the engine as they are; several requests'
        are joined with one copy of their buffers (``lanes.concat_bytes``)."""
        if len(live) == 1:
            req = live[0]
            pks, msgs, sigs, powers = req.pks, req.msgs, req.sigs, req.powers
        else:
            pks, msgs, sigs = lanes.concat_bytes([[req.pks for req in live],
                                                  [req.msgs for req in live],
                                                  [req.sigs for req in live]])
            powers = lanes.concat_powers([lanes.power_column(req.powers) for req in live])
        tally = any(req.tally for req in live)
        t0 = time.perf_counter()
        try:
            mask = self._verify_fn(curve, pks, msgs, sigs, powers, tally)
        except Exception as exc:  # noqa: BLE001 - an engine failure must not
            # wedge clients: they get an error verdict, never a mask
            self._engine_failed(live, f"verify engine failed: {exc}")
            return
        dt = time.perf_counter() - t0
        self.scheduler.note_dispatch(len(sigs), dt)
        m = self.metrics
        m.dispatches.inc(curve=curve)
        m.dispatch_lanes.observe(len(sigs), curve=curve)
        m.dispatch_clients.observe(clients)
        # one mark per distinct trace the dispatch served: a fleet join sees
        # which heights shared this device flush
        traced = [req.trace_ctx for req in live if req.trace_ctx is not None]
        seen = set()
        for ctx in traced:
            if ctx.trace_id in seen:
                continue
            seen.add(ctx.trace_id)
            trace.mark("sidecar.dispatch", ctx=ctx, dispatch_id=dispatch_id, lanes=len(sigs),
                       clients=clients, requests=len(live), seconds=round(dt, 6))
        if len(mask) != len(sigs):
            self._engine_failed(live, f"verify engine returned {len(mask)} verdicts "
                                      f"for {len(sigs)} lanes")
            return
        with self._lock:
            self._engine_failures = 0
            self._dispatches_by_curve[curve] = self._dispatches_by_curve.get(curve, 0) + 1
            self._dispatched_requests += len(live)
            self._dispatched_lanes += len(sigs)
        off = 0
        for req in live:
            n = len(req)
            req.mask = [bool(v) for v in mask[off:off + n]]
            # each request's tally from its own slice, in Python ints: the
            # joint sum belongs to nobody; verify-only requests get 0
            req.tallied = lanes.tally(req.powers, req.mask) if req.tally else 0
            req.dispatch_id = dispatch_id
            req.dispatch_lanes = len(sigs)
            req.dispatch_clients = clients
            req.dispatch_traces = len(traced)
            off += n
            req.finish()
