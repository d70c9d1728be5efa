"""Prometheus-style metrics: the port's copy of ``tmtpu/libs/metrics.py``.

Counters, gauges and histograms in registries, rendered in the text
exposition format 0.0.4. A family's full name is
``tendermint_<subsystem>_<name>``. ``DEFAULT`` is the process-wide
registry of the families the device path feeds (below); the sidecar
daemon keeps its ``sidecar_server_*`` families in a registry of its own
(``sidecar/metrics.py``) and serves both through ``render``, sorted by
name as the reference's one registry renders them.

The families are the reference's, byte for byte in name, HELP, TYPE,
labels and buckets. Labels: ``curve`` = ed25519 | sr25519 | secp256k1;
``backend`` = the device a flush ran on, ``gpu`` or ``cpu`` (the daemon's
own name for it); ``impl`` = ``cuda`` (a hand-written kernel) or ``torch``
(the plain version, on the CPU). The port pads no lane, so every dispatch
passes ``padded=0`` and ``crypto_pad_ratio`` and the compile-cache
families carry no series.

Not registered, since the port has nothing that could feed them: the
breaker (``crypto_breaker_*``), every fallback (``crypto_cpu_fallback_total``,
``crypto_mesh_fallback_total``), the split across cards (the other
``crypto_mesh_*``: the port's verifier uses one device), the per-batch
deadline (``crypto_batch_deadline_exceeded_total``) and the device probe
with its timeout (``crypto_device_probe_*``), and every node-side family.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Tuple

_NAMESPACE = "tendermint"


class _Metric:
    def __init__(self, name: str, help_: str, labels: Tuple[str, ...]):
        self.name = name
        self.help = help_
        self.label_names = labels
        self._values: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        return tuple(str(labels.get(k, "")) for k in self.label_names)

    def value(self, **labels) -> float:
        """One series' value (0 when it has none)."""
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def render(self, kind: str) -> List[str]:
        out = [f"# HELP {self.name} {_esc_help(self.help)}",
               f"# TYPE {self.name} {kind}"]
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.label_names:
            out.append(f"{self.name} 0")
        for key, v in items:
            if self.label_names:
                lbl = ",".join(f'{k}="{_esc_label(val)}"' for k, val in
                               zip(self.label_names, key))
                out.append(f"{self.name}{{{lbl}}} {_fmt(v)}")
            else:
                out.append(f"{self.name} {_fmt(v)}")
        return out


def _fmt(v: float) -> str:
    """Text-format value: +Inf, -Inf and NaN spelled as the format wants
    them, integers without a fraction."""
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return str(int(v)) if v.is_integer() else repr(v)


def _esc_label(v: str) -> str:
    """Label-value escaping: backslash, double quote and newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _esc_help(v: str) -> str:
    """HELP-line escaping: backslash and newline only."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


class Counter(_Metric):
    def inc(self, amount: float = 1.0, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + amount


class Gauge(_Metric):
    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics)."""

    def __init__(self, name, help_, labels, buckets):
        super().__init__(name, help_, labels)
        self.buckets = sorted(buckets)
        self._counts: Dict[Tuple[str, ...], List[int]] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}

    def observe(self, value: float, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            counts = self._counts.setdefault(
                k, [0] * (len(self.buckets) + 1))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            counts[-1] += 1  # +Inf
            self._sums[k] = self._sums.get(k, 0.0) + value

    def totals(self, **labels) -> Tuple[int, float]:
        """(observation count, sum) for one label combination."""
        k = self._key(labels)
        with self._lock:
            counts = self._counts.get(k)
            return ((counts[-1] if counts else 0),
                    self._sums.get(k, 0.0))

    def render(self, kind: str) -> List[str]:
        out = [f"# HELP {self.name} {_esc_help(self.help)}",
               f"# TYPE {self.name} histogram"]
        with self._lock:
            for k, counts in sorted(self._counts.items()):
                lbl_base = [(a, _esc_label(v))
                            for a, v in zip(self.label_names, k)]
                for i, b in enumerate(self.buckets):
                    labels = lbl_base + [("le", _fmt(b))]
                    ls = ",".join(f'{a}="{v}"' for a, v in labels)
                    out.append(f"{self.name}_bucket{{{ls}}} {counts[i]}")
                inf = lbl_base + [("le", "+Inf")]
                ls = ",".join(f'{a}="{v}"' for a, v in inf)
                out.append(f"{self.name}_bucket{{{ls}}} {counts[-1]}")
                base = ",".join(f'{a}="{v}"' for a, v in lbl_base)
                suffix = f"{{{base}}}" if base else ""
                out.append(f"{self.name}_sum{suffix} "
                           f"{_fmt(self._sums.get(k, 0.0))}")
                out.append(f"{self.name}_count{suffix} {counts[-1]}")
        return out


class Registry:
    def __init__(self):
        self._metrics: Dict[str, Tuple[str, _Metric]] = {}
        self._lock = threading.Lock()

    def histogram(self, subsystem: str, name: str, help_: str = "",
                  labels: Tuple[str, ...] = (),
                  buckets=(0.1, 0.5, 1, 2, 5, 10, 30)) -> Histogram:
        return self._get(
            subsystem, name, "histogram",
            lambda full: Histogram(full, help_, tuple(labels), buckets))

    def counter(self, subsystem: str, name: str, help_: str = "",
                labels: Tuple[str, ...] = ()) -> Counter:
        return self._get(subsystem, name, "counter",
                         lambda full: Counter(full, help_, tuple(labels)))

    def gauge(self, subsystem: str, name: str, help_: str = "",
              labels: Tuple[str, ...] = ()) -> Gauge:
        return self._get(subsystem, name, "gauge",
                         lambda full: Gauge(full, help_, tuple(labels)))

    def _get(self, subsystem, name, kind, make):
        full = f"{_NAMESPACE}_{subsystem}_{name}"
        with self._lock:
            if full not in self._metrics:
                self._metrics[full] = (kind, make(full))
            return self._metrics[full][1]

    def items(self) -> List[Tuple[str, Tuple[str, _Metric]]]:
        """(full name, (kind, family)) of every family, sorted by name."""
        with self._lock:
            return sorted(self._metrics.items())

    def render(self) -> str:
        return render(self)


def render(*registries: Registry) -> str:
    """The families of every registry in one exposition, sorted by name."""
    items = sorted(item for reg in registries for item in reg.items())
    lines: List[str] = []
    for _name, (kind, m) in items:
        lines.extend(m.render(kind))
    return "\n".join(lines) + "\n"


DEFAULT = Registry()


# --- the trace-context families the daemon feeds -----------------------------

trace_context_rx = DEFAULT.counter(
    "trace", "context_rx_total",
    "Valid trace contexts decoded from inbound messages",
    labels=("transport",))
trace_context_invalid = DEFAULT.counter(
    "trace", "context_invalid_total",
    "Inbound trace-context fields that failed strict decode (truncated, "
    "oversized, or garbage) and were treated as untraced",
    labels=("transport",))


# --- the crypto batch-verify pipeline families -------------------------------
#
# Observed at every device dispatch: gpu/sharding.py, verify.py,
# sr_verify.py and k1_verify.py.

LANE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048,
                4096, 8192, 16384, 40960)

crypto_batch_size = DEFAULT.histogram(
    "crypto", "batch_size",
    "Signatures per batch-verify dispatch",
    labels=("curve", "backend"), buckets=LANE_BUCKETS)
crypto_pad_ratio = DEFAULT.histogram(
    "crypto", "pad_ratio",
    "Padded-over-actual lane ratio per device dispatch "
    "(bucket rounding waste)",
    labels=("curve",),
    buckets=(1.0, 1.05, 1.1, 1.25, 1.5, 2.0, 4.0, 8.0))
crypto_verify_latency = DEFAULT.histogram(
    "crypto", "verify_latency_seconds",
    "End-to-end batch-verify latency (prep through readback)",
    labels=("curve", "backend", "impl"),
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 0.5, 1, 2.5, 5, 10, 30, 60))
crypto_compile_cache_hits = DEFAULT.counter(
    "crypto", "compile_cache_hits_total",
    "Device dispatches that reused a warm jit cache entry",
    labels=("curve",))
crypto_compile_cache_misses = DEFAULT.counter(
    "crypto", "compile_cache_misses_total",
    "Device dispatches whose padded shape forced a fresh XLA compile",
    labels=("curve",))

# --- the verify-once families (crypto/sigcache.py, crypto/batch.py) ----------

crypto_sigcache_hits = DEFAULT.counter(
    "crypto", "sigcache_hits_total",
    "Batch-verify lanes answered by the verified-signature cache "
    "(no dispatch, no CPU verify)")
crypto_sigcache_misses = DEFAULT.counter(
    "crypto", "sigcache_misses_total",
    "Batch-verify lanes not found in the verified-signature cache")
crypto_sigcache_inserts = DEFAULT.counter(
    "crypto", "sigcache_inserts_total",
    "Verified signatures inserted into the cache")
crypto_sigcache_evictions = DEFAULT.counter(
    "crypto", "sigcache_evictions_total",
    "Cache entries evicted by the per-shard LRU bound")
crypto_sigcache_entries = DEFAULT.gauge(
    "crypto", "sigcache_entries",
    "Verified-signature cache entries currently resident")
crypto_sigcache_dedup_lanes = DEFAULT.counter(
    "crypto", "sigcache_dedup_lanes_total",
    "Batch lanes collapsed onto an identical in-flight lane in the "
    "same batch (one verify, N results)")
crypto_flush_target_lanes = DEFAULT.gauge(
    "crypto", "flush_target_lanes",
    "Adaptive flush scheduler's current target batch size "
    "(arrival rate x device RTT, clamped)")
crypto_tpu_backend_up = DEFAULT.gauge(
    "crypto", "tpu_backend_up",
    "1 when a usable jax device backend answered the probe, else 0")

# (curve, impl, padded lanes) shapes already dispatched in this process,
# the reference's stand-in for its jit cache; the port pads nothing, so
# nothing reaches it
_seen_jit_shapes: set = set()
_seen_jit_lock = threading.Lock()


def observe_crypto_batch(curve: str, backend: str, impl: str, lanes: int,
                         padded: int, seconds: float) -> None:
    """One call per batch-verify dispatch; fans out to the crypto families.
    ``padded`` of 0 means no device padding."""
    crypto_batch_size.observe(lanes, curve=curve, backend=backend)
    crypto_verify_latency.observe(seconds, curve=curve, backend=backend,
                                  impl=impl)
    if padded and lanes:
        crypto_pad_ratio.observe(padded / lanes, curve=curve)
        key = (curve, impl, padded)
        with _seen_jit_lock:
            hit = key in _seen_jit_shapes
            _seen_jit_shapes.add(key)
        if hit:
            crypto_compile_cache_hits.inc(curve=curve)
        else:
            crypto_compile_cache_misses.inc(curve=curve)


def backend_label(device) -> str:
    """The ``backend`` label of a flush on ``device``: ``gpu`` on a CUDA
    card, ``cpu`` on the CPU (the daemon's own names)."""
    return "gpu" if device.type == "cuda" else "cpu"


def impl_label(device) -> str:
    """The ``impl`` label of a single-device dispatch on ``device``: the
    hand-written kernel on a card, the plain version on the CPU."""
    return "cuda" if device.type == "cuda" else "torch"
