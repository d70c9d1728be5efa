"""The port's health listener (``/healthz``, ``/metrics``) against the
reference daemon's (``backend="cpu"``, its ``health_laddr``) on the same
requests: status codes, content types, the ``sidecar_server_*`` families
with their types and label names (but the reference's two mesh families,
which the port does not register), and the counts of requests, protocol
errors, dispatches and dispatch lanes. The reference's registry is
process-wide, so its counts and label names are read from the series that
this daemon's traffic created or changed: a series an earlier test left in
it (the reference's daemon test of the split leaves one in each mesh
family) drops out. The port's start at zero with each daemon. Both health listeners bind port
0 and the test reads back the port each bound. Then the port's own signal:
503 after three engine failures in a row (injected as
tests/test_torch_sidecar.py injects them), 200 after one dispatch that
answers."""

import contextlib
import json
import re
import urllib.error
import urllib.request

import pytest

from tests.test_torch_sidecar import (DEADLINE_S, _connect_raw, _fresh_port_sigcache,  # noqa: F401
                                      _lanes)
from tmtpu.libs import metrics as ref_metrics
from tmtpu.sidecar import protocol as ref_proto
from tmtpu.sidecar.client import SidecarClient, SidecarUnavailable
from tmtpu.sidecar.server import SidecarServer as RefServer
from tmtpu_torch.sidecar.metrics import SidecarMetrics
from tmtpu_torch.sidecar.server import SidecarServer

FAMILY = "tendermint_sidecar_server_"
# the reference's daemon families the port does not register, with the reason
UNREGISTERED = {FAMILY + "mesh_dispatches_total": "the port's daemon serves one card",
                FAMILY + "mesh_occupancy_lanes": "the port's daemon serves one card"}
_SERIES = re.compile(r"^(\w+?)(?:\{(.*)\})? (\S+)$")


def _get(url):
    """(status, content type, body)."""
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.headers["Content-Type"], r.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers["Content-Type"], exc.read().decode()


def _parse(text):
    """({family: type}, {(series name, frozenset of labels): value}) of the
    daemon's families."""
    types, series = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            if name.startswith(FAMILY):
                types[name] = kind
        elif line and not line.startswith("#"):
            name, labels, value = _SERIES.match(line).groups()
            if name.startswith(FAMILY):
                pairs = frozenset(re.findall(r'(\w+)="([^"]*)"', labels or ""))
                series[(name, pairs)] = float(value)
    return types, series


@contextlib.contextmanager
def _daemon(kind, tmp_path):
    addr = f"unix://{tmp_path}/{kind}.sock"
    laddr = "127.0.0.1:0"
    srv = (SidecarServer(addr, device="cpu", health_laddr=laddr) if kind == "port"
           else RefServer(addr, backend="cpu", health_laddr=laddr))
    srv.start()
    try:
        # the port's daemon writes its bound port back into health_laddr;
        # the reference's keeps it on its HTTP server only
        bound = (srv.health_laddr if kind == "port"
                 else "127.0.0.1:%d" % srv._health_httpd.server_address[1])
        yield srv, f"http://{bound}"
    finally:
        srv.stop()


def _traffic(srv):
    """The same requests on either daemon: two verifies with tally, a ping,
    a stats request, and a connection that skips Hello."""
    with contextlib.closing(SidecarClient(srv.addr, client_id="h",
                                          request_deadline_s=DEADLINE_S)) as c:
        first = c.verify("ed25519", _lanes(5, bad={1}, tag=b"h1"), tally=True)
        second = c.verify("ed25519", _lanes(3, tag=b"h2"), tally=True)
        c.ping()
        c.stats()
    s = _connect_raw(srv.addr)
    try:
        ref_proto.write_frame(s.makefile("wb"), ref_proto.Ping(nonce=1))
        ref_proto.FrameReader(s.makefile("rb")).read_msg()
    finally:
        s.close()
    return first[:2], second[:2]


def _compare(tmp_path):
    """Both daemons on the same traffic; returns the port's side after
    asserting it equals the reference's."""
    got = {}
    for kind in ("ref", "port"):
        with _daemon(kind, tmp_path) as (srv, base):
            types0, before = _parse(_get(base + "/metrics")[2])
            results = _traffic(srv)
            health = _get(base + "/healthz")
            metrics = _get(base + "/metrics")
            missing = _get(base + "/nope")
        types, after = _parse(metrics[2])
        if kind == "ref":
            types = {n: t for n, t in types.items() if n not in UNREGISTERED}
            after = {k: v for k, v in after.items()
                     if not k[0].startswith(tuple(UNREGISTERED))}
        delta = {k: v - before.get(k, 0.0) for k, v in after.items()
                 if k[0].endswith(("_total", "_count", "_sum"))}
        # a series with no labels is rendered from the start by either
        # registry (a gauge such as connections may be back at its old
        # value by now); a labelled one counts if this traffic made or
        # moved it
        changed = {}
        for name, labels in (k for k, v in after.items() if not k[1] or before.get(k) != v):
            changed.setdefault(name, set()).update(k for k, _v in labels)
        got[kind] = {
            "results": results,
            "healthz": (health[0], health[1], json.loads(health[2])["healthy"]),
            "metrics": metrics[:2],
            "404": missing[:2],
            "types": types,
            "labels": {name: sorted(keys - {"le"}) for name, keys in changed.items()},
            "counts": {k: v for k, v in delta.items() if v},
        }
    assert got["port"] == got["ref"]
    return got["port"]


def test_healthz_and_metrics_match_the_reference(tmp_path):
    port = _compare(tmp_path)
    assert port["healthz"] == (200, "application/json", True)
    assert port["metrics"] == (200, "text/plain; version=0.0.4")
    assert port["404"][0] == 404
    counts = {(name, dict(labels).get("type") or dict(labels).get("curve")
               or dict(labels).get("kind")): v for (name, labels), v in port["counts"].items()}
    assert counts[(FAMILY + "requests_total", "verify")] == 2
    assert counts[(FAMILY + "requests_total", "hello")] == 1
    assert counts[(FAMILY + "protocol_errors_total", "no-hello")] == 1
    assert counts[(FAMILY + "dispatches_total", "ed25519")] == 2
    assert counts[(FAMILY + "dispatch_lanes_sum", "ed25519")] == 8
    assert set(port["types"]) == {FAMILY + n for n in (
        "connections", "requests_total", "dispatches_total", "dispatch_lanes",
        "dispatch_clients", "queue_lanes", "overloads_total", "protocol_errors_total")}


def test_healthz_and_metrics_match_after_an_earlier_mesh_dispatch(tmp_path):
    """A series left in the reference's process-wide registry by an earlier
    test, as the reference's daemon test of the split leaves one in each
    mesh family, is no difference between the daemons; the port's
    ``/metrics`` has neither family."""
    leaked = (ref_metrics.sidecar_server_mesh_dispatches,
              ref_metrics.sidecar_server_mesh_occupancy_lanes)
    saved = [dict(fam._values) for fam in leaked]
    ref_metrics.sidecar_server_mesh_dispatches.inc(curve="ed25519")
    ref_metrics.sidecar_server_mesh_occupancy_lanes.set(96, device="0")
    try:
        port = _compare(tmp_path)
    finally:
        for fam, values in zip(leaked, saved):
            with fam._lock:
                fam._values.clear()
                fam._values.update(values)
    assert not any("mesh" in name for name in port["labels"])
    assert not set(UNREGISTERED) & set(port["types"])
    assert set(UNREGISTERED) <= set(ref_metrics.DEFAULT._metrics)


def test_healthz_turns_503_after_three_engine_failures_and_back(tmp_path):
    with _daemon("port", tmp_path) as (srv, base), \
            contextlib.closing(SidecarClient(srv.addr, client_id="f",
                                             request_deadline_s=DEADLINE_S)) as c:
        real = srv.coalescer._verify_fn

        def broken(*cols):
            raise RuntimeError("device lost")

        srv.coalescer._verify_fn = broken
        for i in range(3):
            assert _get(base + "/healthz")[0] == 200
            with pytest.raises(SidecarUnavailable, match="backend_down"):
                c.verify("ed25519", _lanes(2, tag=b"f%d" % i))
        status, _ctype, body = _get(base + "/healthz")
        snap = json.loads(body)
        assert status == 503 and snap["healthy"] is False
        assert snap["engine"]["failures"] == 3
        assert snap["engine"]["last_error"] == "verify engine failed: device lost"
        srv.coalescer._verify_fn = real
        assert c.verify("ed25519", _lanes(2, tag=b"ok"))[0] == [True, True]
        status, _ctype, body = _get(base + "/healthz")
        assert status == 200 and json.loads(body)["engine"]["failures"] == 0


def test_short_mask_counts_as_a_failure_and_as_a_dispatch(tmp_path):
    """A mask of the wrong length is answered BACKEND_DOWN and counts toward
    the signal; like the reference, it still counts as a dispatch."""
    with _daemon("port", tmp_path) as (srv, base), \
            contextlib.closing(SidecarClient(srv.addr, client_id="s",
                                             request_deadline_s=DEADLINE_S)) as c:
        srv.coalescer._verify_fn = lambda *cols: [True]
        with pytest.raises(SidecarUnavailable):
            c.verify("ed25519", _lanes(3, tag=b"short"))
        snap = srv.snapshot()
    assert snap["engine"]["failures"] == 1
    assert snap["engine"]["last_error"] == "verify engine returned 1 verdicts for 3 lanes"
    assert srv.metrics.dispatches.value(curve="ed25519") == 1


def test_renderer_escapes_and_formats():
    m = SidecarMetrics()
    m.protocol_errors.inc(kind='a"b\\c\nd')
    m.dispatch_lanes.observe(3, curve="ed25519")
    m.dispatch_lanes.observe(40961, curve="ed25519")
    m.queue_lanes.set(2.5)
    text = m.render()
    assert 'tendermint_sidecar_server_protocol_errors_total{kind="a\\"b\\\\c\\nd"} 1' in text
    assert 'tendermint_sidecar_server_dispatch_lanes_bucket{curve="ed25519",le="4"} 1' in text
    assert 'tendermint_sidecar_server_dispatch_lanes_bucket{curve="ed25519",le="+Inf"} 2' in text
    assert 'tendermint_sidecar_server_dispatch_lanes_sum{curve="ed25519"} 40964' in text
    assert "tendermint_sidecar_server_queue_lanes 2.5" in text
    assert "tendermint_sidecar_server_overloads_total 0" in text
    assert text.endswith("\n")


def test_metrics_serves_the_device_path_families_sorted(tmp_path):
    """``/metrics`` renders the daemon's families and the process-wide
    device-path registry together, sorted by name as the reference renders
    its one registry; the daemon's block is byte for byte its own renderer's
    output, and the batch count follows the dispatches."""
    from tmtpu_torch.libs import metrics as lib_metrics

    with _daemon("port", tmp_path) as (srv, base):
        before = _get(base + "/metrics")[2]
        with contextlib.closing(SidecarClient(srv.addr, client_id="m",
                                              request_deadline_s=DEADLINE_S)) as c:
            c.verify("ed25519", _lanes(4, bad={2}, tag=b"m1"), tally=True)
        text = _get(base + "/metrics")[2]
        own = srv.metrics.render()
    families = [line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")]
    assert families == sorted(families)
    assert set(families) == {name for reg in (lib_metrics.DEFAULT, srv.metrics.registry)
                             for name, _fam in reg.items()}
    assert own in text

    def count(body, name):
        m = re.search(rf"^{name} (\S+)$", body, re.M)
        return float(m.group(1)) if m else 0.0

    batches = 'tendermint_crypto_batch_size_count{curve="ed25519",backend="cpu"}'
    dispatches = FAMILY + 'dispatches_total{curve="ed25519"}'
    assert count(text, re.escape(dispatches)) == 1
    assert count(text, re.escape(batches)) - count(before, re.escape(batches)) == 1


def test_trace_context_counters_match_the_reference(tmp_path):
    """One request with a valid v2 trace context and one with garbage:
    each daemon's ``/metrics`` counts one ``trace_context_rx_total`` and
    one ``trace_context_invalid_total`` (``transport="sidecar"``)."""
    from tmtpu_torch.libs import trace
    from tmtpu_torch.sidecar import protocol as proto

    good = trace.TraceContext("0011223344556677", 3, "node").encode()
    got = {}
    for kind in ("ref", "port"):
        with _daemon(kind, tmp_path) as (srv, base):
            before = _get(base + "/metrics")[2]
            for rid, ctx in ((1, good), (2, b"\x01garbage")):
                cols = [list(c) for c in zip(*_lanes(1, tag=b"ctx%d" % rid))]
                s = _connect_raw(srv.addr)
                s.settimeout(DEADLINE_S)
                try:
                    proto.write_frame(s.makefile("wb"), proto.Hello(version=2, client_id="t"))
                    rd = proto.FrameReader(s.makefile("rb"))
                    rd.read_msg()
                    s.sendall(proto.encode_verify_frame(rid, "ed25519", False, 0, *cols,
                                                        trace_ctx=ctx))
                    assert rd.read_msg().status == proto.STATUS_OK
                finally:
                    s.close()
            after = _get(base + "/metrics")[2]
        got[kind] = {
            name: sum(float(v) for v in re.findall(
                rf'^tendermint_trace_{name}_total{{transport="sidecar"}} (\S+)$', after, re.M))
            - sum(float(v) for v in re.findall(
                rf'^tendermint_trace_{name}_total{{transport="sidecar"}} (\S+)$', before, re.M))
            for name in ("context_rx", "context_invalid")}
    assert got["port"] == got["ref"] == {"context_rx": 1.0, "context_invalid": 1.0}
