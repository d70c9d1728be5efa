"""The daemon's own metric families: the reference's ``sidecar_server_*``
(``tmtpu/libs/metrics.py``) under the same names, labels, help and
buckets, fed by the server (connections, requests, protocol errors) and
the coalescer (queue lanes, overloads, dispatches, dispatch lanes and
clients). The reference's two mesh families are not registered: the
daemon serves one card.

They live in a registry of the daemon's own, so each daemon starts at
zero; ``/metrics`` renders it together with the process-wide registry of
the device path (``libs/metrics.py``) through the one renderer there.
"""

from __future__ import annotations

from tmtpu_torch.libs import metrics


class SidecarMetrics:
    """The daemon's families, as the reference defines them."""

    def __init__(self):
        self.registry = reg = metrics.Registry()
        self.connections = reg.gauge(
            "sidecar", "server_connections",
            "Client connections currently held by the sidecar daemon")
        self.requests = reg.counter(
            "sidecar", "server_requests_total",
            "Protocol messages handled by the sidecar daemon", labels=("type",))
        self.dispatches = reg.counter(
            "sidecar", "server_dispatches_total",
            "Joint device dispatches issued by the cross-client coalescer",
            labels=("curve",))
        self.dispatch_lanes = reg.histogram(
            "sidecar", "server_dispatch_lanes", "Lanes per joint coalesced dispatch",
            labels=("curve",), buckets=metrics.LANE_BUCKETS)
        self.dispatch_clients = reg.histogram(
            "sidecar", "server_dispatch_clients",
            "Distinct clients whose lanes shared one coalesced dispatch",
            buckets=(1, 2, 3, 4, 6, 8, 12, 16, 32))
        self.queue_lanes = reg.gauge(
            "sidecar", "server_queue_lanes",
            "Lanes currently queued in the coalescer awaiting dispatch")
        self.overloads = reg.counter(
            "sidecar", "server_overloads_total",
            "Verify requests rejected by admission control (queue full)")
        self.protocol_errors = reg.counter(
            "sidecar", "server_protocol_errors_total",
            "Malformed frames / bad sequencing / version mismatches rejected by the "
            "sidecar daemon", labels=("kind",))

    def render(self) -> str:
        """The daemon's families alone."""
        return self.registry.render()
