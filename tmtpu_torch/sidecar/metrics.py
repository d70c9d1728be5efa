"""The daemon's metrics in the Prometheus text format 0.0.4, served at
``/metrics`` by the health listener (``server.py``).

The port's own small renderer, and one ``SidecarMetrics`` a daemon: the
reference's ``sidecar_server_*`` families (``tmtpu/libs/metrics.py``) under
the same names, labels, help and buckets, fed by the server (connections,
requests, protocol errors) and the coalescer (queue lanes, overloads,
dispatches, dispatch lanes and clients, mesh dispatches and occupancy).
Nothing else: the reference's node-side families are not the daemon's.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Tuple

NAMESPACE = "tendermint"

# the reference's lane buckets (tmtpu/libs/metrics.py _LANE_BUCKETS)
LANE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 40960)
CLIENT_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 32)


def _fmt(v: float) -> str:
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return str(int(v)) if v.is_integer() else repr(v)


def _esc_label(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _esc_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _labels(pairs) -> str:
    return ",".join(f'{k}="{_esc_label(v)}"' for k, v in pairs)


class Metric:
    """A counter or gauge family: one value per label tuple."""

    def __init__(self, kind: str, name: str, help_: str, labels: Tuple[str, ...] = ()):
        self.kind = kind
        self.name = f"{NAMESPACE}_sidecar_{name}"
        self.help = help_
        self.label_names = labels
        self._values: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def _key(self, labels) -> Tuple[str, ...]:
        return tuple(str(labels.get(k, "")) for k in self.label_names)

    def inc(self, amount: float = 1.0, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + amount

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {_esc_help(self.help)}", f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.label_names:
            out.append(f"{self.name} 0")
        for key, v in items:
            lbl = _labels(zip(self.label_names, key))
            out.append(f"{self.name}{{{lbl}}} {_fmt(v)}" if lbl else f"{self.name} {_fmt(v)}")
        return out


class Histogram(Metric):
    """Cumulative buckets, a sum and a count per label tuple."""

    def __init__(self, name: str, help_: str, labels: Tuple[str, ...], buckets):
        super().__init__("histogram", name, help_, labels)
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[Tuple[str, ...], List[int]] = {}

    def observe(self, value: float, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            counts = self._counts.setdefault(k, [0] * (len(self.buckets) + 1))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            counts[-1] += 1
            self._values[k] = self._values.get(k, 0.0) + value

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {_esc_help(self.help)}", f"# TYPE {self.name} histogram"]
        with self._lock:
            items = sorted((k, list(c), self._values[k]) for k, c in self._counts.items())
        for key, counts, total in items:
            base = list(zip(self.label_names, key))
            for b, c in zip(self.buckets + (math.inf,), counts):
                out.append(f"{self.name}_bucket{{{_labels(base + [('le', _fmt(b))])}}} {c}")
            suffix = f"{{{_labels(base)}}}" if base else ""
            out.append(f"{self.name}_sum{suffix} {_fmt(total)}")
            out.append(f"{self.name}_count{suffix} {counts[-1]}")
        return out


class SidecarMetrics:
    """The daemon's families, as the reference defines them."""

    def __init__(self):
        self.connections = Metric(
            "gauge", "server_connections",
            "Client connections currently held by the sidecar daemon")
        self.requests = Metric(
            "counter", "server_requests_total",
            "Protocol messages handled by the sidecar daemon", ("type",))
        self.dispatches = Metric(
            "counter", "server_dispatches_total",
            "Joint device dispatches issued by the cross-client coalescer", ("curve",))
        self.dispatch_lanes = Histogram(
            "server_dispatch_lanes", "Lanes per joint coalesced dispatch", ("curve",),
            LANE_BUCKETS)
        self.dispatch_clients = Histogram(
            "server_dispatch_clients",
            "Distinct clients whose lanes shared one coalesced dispatch", (), CLIENT_BUCKETS)
        self.queue_lanes = Metric(
            "gauge", "server_queue_lanes",
            "Lanes currently queued in the coalescer awaiting dispatch")
        self.overloads = Metric(
            "counter", "server_overloads_total",
            "Verify requests rejected by admission control (queue full)")
        self.protocol_errors = Metric(
            "counter", "server_protocol_errors_total",
            "Malformed frames / bad sequencing / version mismatches rejected by the "
            "sidecar daemon", ("kind",))
        self.mesh_dispatches = Metric(
            "counter", "server_mesh_dispatches_total",
            "Joint coalesced dispatches that rode the multi-chip mesh path", ("curve",))
        self.mesh_occupancy = Metric(
            "gauge", "server_mesh_occupancy_lanes",
            "Cumulative sharded lanes dispatched to each mesh device by this daemon",
            ("device",))

    def render(self) -> str:
        families = sorted((m for m in vars(self).values() if isinstance(m, Metric)),
                          key=lambda m: m.name)
        return "\n".join(line for m in families for line in m.render()) + "\n"
