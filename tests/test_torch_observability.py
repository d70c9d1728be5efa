"""The device path's observability in the port (tmtpu_torch/libs/: the span
ring, the metric registry, and their call sites on the flush and the
sidecar daemon) held against the reference's (tmtpu/libs/) on the CPU,
where the port runs its plain versions.

- Span names: the port records the reference's names (parsed from the
  reference's ``trace.span("...")`` literals), but for the listed
  exceptions, and its own listed ones; and the reference's tree of a
  fused flush (names, parents, ``lanes``).
- Metric families: each one the port registers has the reference's name,
  TYPE, HELP, labels and buckets; the renderer gives the reference's bytes.
- Trace contexts: the port's strict decode agrees with the reference's on
  generated bytes, valid and garbage.
- The daemons side by side: on the same requests, batch counts and sums
  per curve, the signature cache's counters on verify-once traffic and the
  trace-context counters agree; so do the ``sidecar.dispatch`` marks of
  one joint dispatch.
"""

import ast
import contextlib
import json
import os
import re
import struct

import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tests import torch_corpus as corpus
from tests.test_torch_mixed import mixed_items
from tests.test_torch_sidecar import (DEADLINE_S, _connect_raw, _fix_window,  # noqa: F401
                                      _fresh_port_sigcache, _lanes)
from tests.test_torch_sidecar_health import UNREGISTERED as SIDECAR_UNREGISTERED
from tmtpu.crypto import batch as jbatch
from tmtpu.libs import metrics as jm
from tmtpu.libs import trace as jtrace
from tmtpu.sidecar.client import SidecarClient
from tmtpu.sidecar.server import SidecarServer as RefServer
from tmtpu.tpu import sharding as jsh
from tmtpu_torch.crypto import batch
from tmtpu_torch.gpu import sharding
from tmtpu_torch.libs import metrics, trace
from tmtpu_torch.sidecar import protocol as proto
from tmtpu_torch.sidecar.coalescer import AdaptiveFlushScheduler
from tmtpu_torch.sidecar.metrics import SidecarMetrics
from tmtpu_torch.sidecar.server import SidecarServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

# the reference's spans the port does not record, each with its reason
NOT_RECORDED = {
    "ed25519.pad": "the port pads no lane; the power limbs the reference builds "
                   "in this stage are built in the port's upload, under "
                   "ed25519.device_put",
    "crypto.mesh_verify_tally": "the port's verifier uses one device: no flush splits "
                                "across cards",
    "crypto.mesh_verify": "the port's verifier uses one device: no flush splits across cards",
}

# the port's spans the reference does not record, each with its reason
_DAEMON = "the port's daemon times each request's path outside the flush's tree"
PORT_ONLY = {
    "crypto.pack_words": "the device bit pack of bit_words and its readback, which "
                         "the reference fuses into its XLA step",
    "sigcache.resolve": "the signature cache's one C call and the bookkeeping up to the "
                        "lanes to dispatch",
    "sigcache.insert": "the successes added to the signature cache",
    "sidecar.recv": _DAEMON, "sidecar.decode": _DAEMON, "sidecar.admit": _DAEMON,
    "sidecar.handoff": _DAEMON, "sidecar.reply": _DAEMON,
    "coalescer.queue_wait": _DAEMON, "coalescer.dispatch": _DAEMON,
    "secp256k1.device_put": "the plane's copy to the device, which the reference's "
                            "secp256k1.execute holds (tmtpu/tpu/k1_verify.py:476); the port "
                            "times it apart, as on the ed25519 path",
    "secp256k1.readback": "the mask's copy back, which the reference's secp256k1.execute "
                          "holds; the port times it apart, as on the ed25519 path",
    "crypto.host_tally": "the host's sum of the valid lanes' powers of a curve the device "
                         "does not tally, which the reference sums under no span",
}

# the reference's crypto families the port does not register, each with its reason
_ONE_DEVICE = "the port's verifier uses one device: no flush splits across cards"
UNREGISTERED = {
    "tendermint_crypto_cpu_fallback_total": "no CPU fallback",
    "tendermint_crypto_breaker_state": "no breaker",
    "tendermint_crypto_breaker_transitions_total": "no breaker",
    "tendermint_crypto_breaker_failures_total": "no breaker",
    "tendermint_crypto_batch_deadline_exceeded_total": "no per-batch deadline re-verify",
    "tendermint_crypto_device_probe_attempts_total": "no device probe",
    "tendermint_crypto_device_probe_timeouts_total": "no device probe",
    "tendermint_crypto_mesh_fallback_total": "no fallback off the mesh",
    "tendermint_crypto_mesh_devices": _ONE_DEVICE,
    "tendermint_crypto_mesh_dispatches_total": _ONE_DEVICE,
    "tendermint_crypto_mesh_shard_lanes": _ONE_DEVICE,
    "tendermint_crypto_mesh_pad_ratio": _ONE_DEVICE,
    "tendermint_crypto_mesh_psum_seconds": _ONE_DEVICE,
    "tendermint_crypto_flush_gather_waits_total": "a node's receive loop waits, not the daemon",
}


# --- span names and trees ---------------------------------------------------------


def _reference_span_names():
    """Every ``trace.span("...")`` literal of the reference's device path,
    the modules of tmtpu/tpu/."""
    names = set()
    tpu = os.path.join(ROOT, "tmtpu", "tpu")
    for name in sorted(f for f in os.listdir(tpu) if f.endswith(".py")):
        with open(os.path.join(tpu, name), encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "span" and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "trace" and node.args
                    and isinstance(node.args[0], ast.Constant)):
                names.add(node.args[0].value)
    return names


def _spans_of(fn):
    """(fn's result, the spans it recorded on the port's ring)."""
    trace.drain()
    out = fn()
    return out, trace.drain()


def _ed_lanes(n, seed):
    pks, msgs, sigs = corpus.signed(n, seed)
    return pks, msgs, sigs, [7 + i for i in range(n)]


@pytest.fixture(scope="module")
def flushes():
    """Spans of the port's flushes on the CPU, with the cache off so each
    flush dispatches: a 64-lane ed25519 verify_tally and verify, and a
    mixed set of 8 lanes a curve; each verify_tally's ``bit_words`` is read
    inside, so its pack is among the spans."""
    from tmtpu_torch.crypto import sigcache

    sigcache.DEFAULT.set_enabled(False)
    try:
        out = {}
        pks, msgs, sigs, powers = _ed_lanes(64, 61)

        def flush(tally):
            bv = batch.TorchBatchVerifier(CPU)
            bv.add_lanes("ed25519", pks, msgs, sigs, powers)
            if not tally:
                return bv.verify()
            got = bv.verify_tally()
            assert bv.bit_words is not None
            return got

        out["ed25519 tally"] = _spans_of(lambda: flush(True))
        out["ed25519 mask"] = _spans_of(lambda: flush(False))
        items = mixed_items(("ed25519", "sr25519", "secp256k1"), n=24)

        def mixed():
            bv = batch.TorchBatchVerifier(CPU)
            for key, _ref_key, msg, sig, power in items:
                bv.add(key, msg, sig, power)
            got = bv.verify_tally()
            assert bv.bit_words is not None
            return got

        out["mixed"] = _spans_of(mixed)
        return out
    finally:
        sigcache.DEFAULT.set_enabled(True)


def test_span_names_are_the_references_but_the_listed_exceptions(flushes):
    reference = _reference_span_names()
    recorded = {sp.name for _out, spans in flushes.values() for sp in spans}
    assert not reference & set(PORT_ONLY)
    assert "sidecar.dispatch" not in PORT_ONLY  # a mark, the reference's
    assert recorded <= reference | set(PORT_ONLY), recorded - reference - set(PORT_ONLY)
    assert reference - recorded == set(NOT_RECORDED)


def _tree(spans):
    """[(name, parent's name, lanes attr)] in start order."""
    by_id = {sp.span_id: sp for sp in spans}
    return [(sp.name, by_id[sp.parent_id].name if sp.parent_id in by_id else None,
             sp.attrs.get("lanes"))
            for sp in sorted(spans, key=lambda s: (s.start_s, s.span_id))]


def test_fused_flush_span_tree(flushes):
    (_ok, mask, tally), spans = flushes["ed25519 tally"]
    root = "crypto.batch_verify_tally"
    assert _tree(spans) == [(root, None, 64), ("ed25519.prepare", root, 64),
                            ("ed25519.device_put", root, None),
                            ("ed25519.execute", root, None),
                            ("ed25519.readback", root, None),
                            ("crypto.pack_words", None, 64)]
    by_name = {sp.name: sp for sp in spans}
    parent = by_name[root]
    assert parent.attrs == {"curve": "ed25519", "lanes": 64, "impl": "torch"}
    assert by_name["ed25519.execute"].attrs == {"impl": "torch"}  # no device_ms on the CPU
    children = [sp for sp in spans if sp.parent_id == parent.span_id]
    assert sum(sp.duration_s for sp in children) <= parent.duration_s
    assert all(mask) and tally == sum(7 + i for i in range(64))
    (_ok, _mask), spans = flushes["ed25519 mask"]
    root = "crypto.batch_verify"
    assert [t[:2] for t in _tree(spans)] == [
        (root, None), ("ed25519.prepare", root), ("ed25519.device_put", root),
        ("ed25519.execute", root), ("ed25519.readback", root)]


def test_cached_flush_span_roots():
    """A cold verify_tally with the cache on (as ``chip_smoke.py``'s
    observability phase runs it): the resolve (no hits), the flush's tree,
    the insert of the successes and the bit pack, each a root."""
    pks, msgs, sigs, powers = _ed_lanes(64, 64)
    bv = batch.TorchBatchVerifier(CPU)
    bv.add_lanes("ed25519", pks, msgs, sigs, powers)
    (ok, _mask, _tally), spans = _spans_of(lambda: (bv.verify_tally(), bv.bit_words)[0])
    assert ok
    root = "crypto.batch_verify_tally"
    assert _tree(spans) == [("sigcache.resolve", None, 64), (root, None, 64),
                            ("ed25519.prepare", root, 64),
                            ("ed25519.device_put", root, None),
                            ("ed25519.execute", root, None),
                            ("ed25519.readback", root, None),
                            ("sigcache.insert", None, 64),
                            ("crypto.pack_words", None, 64)]
    # lists given to add_lanes are joined into columns at the flush
    assert {sp.name: sp for sp in spans}["sigcache.resolve"].attrs == {
        "lanes": 64, "hits": 0, "columns": "joined"}


def test_mixed_flush_records_one_execute_a_curve(flushes):
    (_ok, _mask, _tally), spans = flushes["mixed"]
    tree = _tree(spans)
    assert tree == [("crypto.batch_verify_tally", None, 8),
                    ("ed25519.prepare", "crypto.batch_verify_tally", 8),
                    ("ed25519.device_put", "crypto.batch_verify_tally", None),
                    ("ed25519.execute", "crypto.batch_verify_tally", None),
                    ("ed25519.readback", "crypto.batch_verify_tally", None),
                    ("sr25519.prepare", None, 8), ("sr25519.execute", None, 8),
                    ("crypto.host_tally", None, 8),
                    ("secp256k1.prepare", None, 8), ("secp256k1.device_put", None, 8),
                    ("secp256k1.execute", None, 8), ("secp256k1.readback", None, 8),
                    ("crypto.host_tally", None, 8),
                    ("crypto.pack_words", None, 24)]
    assert [sp.attrs for sp in spans if sp.name in ("sr25519.execute", "secp256k1.execute")] == [
        {"impl": "torch", "lanes": 8}] * 2
    assert [sp.attrs for sp in spans if sp.name == "crypto.host_tally"] == [
        {"curve": "sr25519", "lanes": 8}, {"curve": "secp256k1", "lanes": 8}]


def _stand_in_step():
    """The reference's fused XLA step replaced by a stand-in with its
    outputs' shapes (every lane valid, the limb sums of every lane, no
    bits): the span tree around it is the reference's own code."""
    def step(packed, power_limbs, *_table):
        padded = packed.shape[-1]
        return (jnp.ones(padded, dtype=bool), jnp.sum(power_limbs, axis=1),
                jnp.zeros(padded // 32, dtype=jnp.uint32))
    return step


def _reference_tree(lanes):
    pks, msgs, sigs, powers = _ed_lanes(lanes, 63)
    jtrace.drain()
    mask, tally = jsh.batch_verify_tally(pks, msgs, sigs, powers)
    spans = jtrace.drain()
    assert mask.all() and tally == sum(powers)
    return _tree(spans)


def _port_tree(lanes):
    pks, msgs, sigs, powers = _ed_lanes(lanes, 63)
    (mask, tally), spans = _spans_of(
        lambda: sharding.batch_verify_tally(pks, msgs, sigs, powers, device=CPU))
    assert mask.all() and tally == sum(powers)
    return _tree(spans)


def _without_listed(tree):
    return [t for t in tree if t[0] not in NOT_RECORDED]


def test_span_tree_matches_the_reference(monkeypatch):
    """The port's tree of an 8-lane fused flush against the reference's
    ``sharding.batch_verify_tally`` on JAX's CPU, with the reference's XLA
    step (~40 s of XLA:CPU compile; the slow test below runs it) replaced
    by a stand-in."""
    monkeypatch.setattr(jsh, "_fused_step", _stand_in_step)
    monkeypatch.setattr(jsh.tv, "use_pallas_kernel", lambda: False)
    reference = _reference_tree(8)
    assert [t[0] for t in reference if t[0] in NOT_RECORDED] == ["ed25519.pad"]
    assert _port_tree(8) == _without_listed(reference)


@pytest.mark.slow  # the reference's fused step compiles on XLA:CPU (~40 s)
def test_span_tree_matches_the_reference_xla():
    assert _port_tree(8) == _without_listed(_reference_tree(8))


# --- metric families --------------------------------------------------------------

PORT_FAMILIES = {name: fam for reg in (metrics.DEFAULT, SidecarMetrics().registry)
                 for name, fam in reg.items()}


@pytest.mark.parametrize("name", sorted(PORT_FAMILIES))
def test_family_is_the_references(name):
    kind, fam = PORT_FAMILIES[name]
    ref_kind, ref = jm.DEFAULT._metrics[name]
    assert (kind, fam.help, fam.label_names, getattr(fam, "buckets", None)) == \
        (ref_kind, ref.help, ref.label_names, getattr(ref, "buckets", None))


@pytest.mark.parametrize("name", sorted(UNREGISTERED) + sorted(SIDECAR_UNREGISTERED))
def test_unregistered_family_is_the_references_and_never_rendered(name):
    """Each family the port leaves out is one of the reference's, and the
    exposition of the port's registries, as the daemon's ``/metrics``
    renders them, has no line of it."""
    assert name in jm.DEFAULT._metrics and name not in PORT_FAMILIES
    text = metrics.render(metrics.DEFAULT, SidecarMetrics().registry)
    assert not re.search(rf"^(# (HELP|TYPE) )?{name}\b", text, re.M)


def test_unregistered_crypto_families_are_the_listed_ones():
    reference = {n for n in jm.DEFAULT._metrics if n.startswith("tendermint_crypto_")}
    port = {n for n in PORT_FAMILIES if n.startswith("tendermint_crypto_")}
    assert port <= reference
    assert reference - port == set(UNREGISTERED)
    trace_families = {n for n in PORT_FAMILIES if n.startswith("tendermint_trace_")}
    assert trace_families == {"tendermint_trace_context_rx_total",
                              "tendermint_trace_context_invalid_total"}


def test_renderer_gives_the_references_bytes():
    """The same families and observations in a fresh registry of each give
    the same exposition, escapes and special values included."""
    texts = []
    for mod in (jm, metrics):
        reg = mod.Registry()
        c = reg.counter("crypto", "x_total", 'help with "quotes" and \\ and\nnewline',
                        labels=("curve", "kind"))
        c.inc(3, curve="ed25519", kind='a"b\\c\nd')
        c.inc(curve="sr25519", kind="")
        g = reg.gauge("sidecar", "g", "a gauge")
        g.set(2.5)
        reg.gauge("sidecar", "empty", "never set")
        reg.counter("crypto", "labelled_empty_total", "no series", labels=("curve",))
        h = reg.histogram("crypto", "h", "a histogram", labels=("curve",),
                          buckets=metrics.LANE_BUCKETS)
        for v in (1, 3, 40961, float("inf")):
            h.observe(v, curve="ed25519")
        u = reg.histogram("trace", "u", "unlabelled", buckets=(0.001, 0.5))
        u.observe(0.25)
        texts.append(reg.render())
    assert texts[0] == texts[1]


def test_scheduler_target_sets_the_gauge():
    ref, port = jbatch.AdaptiveFlushScheduler(), AdaptiveFlushScheduler()
    assert port.target_lanes() == ref.target_lanes() == 8
    assert metrics.crypto_flush_target_lanes.value() == 8
    with port._lock:
        port._rate, port._rtt = 100_000.0, 0.01
    assert port.target_lanes() == 1000
    assert metrics.crypto_flush_target_lanes.value() == 1000


# --- trace contexts ---------------------------------------------------------------


def _ctx_bytes(tid, parent, flags, origin, version=1, olen=None):
    origin = origin[:64]
    return (bytes([version]) + tid + struct.pack(">Q", parent)
            + bytes([flags, len(origin) if olen is None else olen]) + origin)


_CTX = st.one_of(
    st.binary(max_size=80),
    st.builds(_ctx_bytes, st.binary(min_size=8, max_size=8),
              st.integers(0, 2 ** 64 - 1), st.integers(0, 255),
              st.binary(max_size=44),
              st.sampled_from([1, 1, 1, 0, 2]),
              st.one_of(st.none(), st.integers(0, 255))),
    st.builds(lambda t, p, o: jtrace.TraceContext(t.hex(), p, o).encode(),
              st.binary(min_size=8, max_size=8), st.integers(0, 2 ** 64 - 1),
              st.text(alphabet=st.characters(max_codepoint=127), max_size=40)),
)


@settings(max_examples=300, deadline=None)
@given(_CTX)
def test_trace_context_decode_agrees_with_the_reference(raw):
    ref = jtrace.TraceContext.decode(raw)
    port = trace.TraceContext.decode(raw)
    assert (None if ref is None else ref.to_dict()) == (None if port is None else port.to_dict())
    assert (trace.adopt(raw) is None) == (ref is None)
    if port is not None:
        assert port.encode() == ref.encode() == bytes(raw)


def test_trace_ctx_valid_is_the_strict_decode():
    from tmtpu_torch.sidecar.server import trace_ctx_valid

    good = trace.TraceContext("0001020304050607", 5, "node").encode()
    assert trace_ctx_valid(good) and not trace_ctx_valid(good[:-1])
    assert trace.TRACE_MARKS == ("sidecar.dispatch",)
    assert set(trace.TRACE_MARKS) <= set(jtrace.TRACE_MARKS)


# --- the daemons side by side -----------------------------------------------------

_SERIES = re.compile(r"^(\w+?)(?:\{(.*)\})? (\S+)$")


def _series(text):
    """{(name, frozenset of labels): value} of an exposition."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, labels, value = _SERIES.match(line).groups()
            out[(name, frozenset(re.findall(r'(\w+)="([^"]*)"', labels or "")))] = float(value)
    return out


def _exposition(kind, srv):
    return (metrics.render(metrics.DEFAULT, srv.metrics.registry) if kind == "port"
            else jm.render_prometheus())


@contextlib.contextmanager
def _daemon(kind, tmp_path):
    addr = f"unix://{tmp_path}/{kind}-obs.sock"
    srv = (SidecarServer(addr, device="cpu") if kind == "port"
           else RefServer(addr, backend="cpu"))
    srv.start()
    try:
        yield srv
    finally:
        srv.stop()


def _send_raw(srv, frames):
    """Send verify frames pipelined on one v2 connection; returns the
    replies by request id."""
    s = _connect_raw(srv.addr)
    s.settimeout(DEADLINE_S)
    try:
        proto.write_frame(s.makefile("wb"), proto.Hello(version=2, client_id="raw"))
        rd = proto.FrameReader(s.makefile("rb"))
        assert isinstance(rd.read_msg(), proto.HelloAck)
        s.sendall(b"".join(frames))
        replies = [rd.read_msg() for _ in frames]
    finally:
        s.close()
    return {r.request_id: r for r in replies}


def _frame(rid, curve, lanes, ctx):
    cols = [list(c) for c in zip(*lanes)]
    return proto.encode_verify_frame(rid, curve, True, 0, *cols, trace_ctx=ctx)


GOOD_CTX = trace.TraceContext("00112233445566ff", 9, "node-a").encode()


def _verify_once_traffic(srv):
    """A 20-validator height verified once over the wire (as
    tests/test_sigcache.py:368 verifies it in process): the ingestion
    request with every 4th vote relayed a second time, then the commit's
    same 20 triples; one sr25519 and one secp256k1 request; and a request
    with a valid v2 trace context and one with garbage."""
    votes = _lanes(20, bad={3}, tag=b"obs-height")
    other = mixed_items(("sr25519", "secp256k1"), n=8, seed=47)
    by_curve = {c: [(k.bytes(), m, s, p) for k, _r, m, s, p in other if k.type_value() == c]
                for c in ("sr25519", "secp256k1")}
    with contextlib.closing(SidecarClient(srv.addr, client_id="node",
                                          request_deadline_s=DEADLINE_S)) as c:
        got = [c.verify("ed25519", votes + votes[::4], tally=True)[:2],
               c.verify("ed25519", votes, tally=True)[:2]]
        got += [c.verify(curve, lanes, tally=True)[:2] for curve, lanes in by_curve.items()]
    # one connection each, one after another: each is a dispatch of its own
    replies = [_send_raw(srv, [_frame(1, "ed25519", _lanes(2, tag=b"obs-" + tag), ctx)])[1]
               for tag, ctx in ((b"ctx", GOOD_CTX), (b"bad", b"\x01garbage"))]
    return got, [(r.status, r.tallied, r.dispatch_traces) for r in replies]


def _counts(before, after):
    """The deltas the two daemons are held to: batch counts and sums per
    curve (``backend`` and ``impl`` ignored), the cache's counters and
    resident entries, and the trace-context counters."""
    out = {}
    for (name, labels), v in after.items():
        d = dict(labels)
        delta = v - before.get((name, labels), 0.0)
        if name in ("tendermint_crypto_batch_size_count", "tendermint_crypto_batch_size_sum"):
            key = (name, d["curve"])
        elif name.startswith("tendermint_crypto_sigcache_") or name.startswith(
                "tendermint_trace_context_"):
            key = (name, d.get("transport"))
            if name == "tendermint_crypto_sigcache_entries":
                delta = v  # a gauge: both caches start empty
        else:
            continue
        out[key] = out.get(key, 0.0) + delta
    return {k: v for k, v in out.items() if v}


def test_daemons_agree_on_batch_cache_and_trace_counters(tmp_path):
    got = {}
    for kind in ("ref", "port"):
        with _daemon(kind, tmp_path) as srv:
            before = _series(_exposition(kind, srv))
            results = _verify_once_traffic(srv)
            after = _series(_exposition(kind, srv))
        got[kind] = (results, _counts(before, after))
    assert got["port"] == got["ref"]
    counts = got["port"][1]
    assert counts[("tendermint_crypto_sigcache_dedup_lanes_total", None)] == 5
    assert counts[("tendermint_crypto_sigcache_hits_total", None)] == 19
    assert counts[("tendermint_trace_context_rx_total", "sidecar")] == 1
    assert counts[("tendermint_trace_context_invalid_total", "sidecar")] == 1
    assert counts[("tendermint_crypto_batch_size_count", "ed25519")] == 4


# --- marks ----------------------------------------------------------------------


def test_one_dispatch_mark_per_distinct_trace(tmp_path):
    """Three traced requests in one joint dispatch, two of them on one
    trace: each daemon marks the dispatch once per distinct trace id."""
    ctx_a = jtrace.TraceContext("aa00000000000001", 1, "node-a")
    ctx_a2 = jtrace.TraceContext("aa00000000000001", 2, "node-b")
    ctx_b = jtrace.TraceContext("bb00000000000002", 3, "node-c")
    frames = [_frame(i + 1, "ed25519", _lanes(2, tag=b"mark%d" % i), ctx.encode())
              for i, ctx in enumerate((ctx_a, ctx_b, ctx_a2))]
    got = {}
    for kind, tr in (("ref", jtrace), ("port", trace)):
        with _daemon(kind, tmp_path) as srv:
            _fix_window(srv, 0.5)
            tr.drain()
            replies = _send_raw(srv, frames)
            marks = [sp for sp in tr.drain() if sp.name == "sidecar.dispatch"]
        got[kind] = (
            sorted((r.dispatch_lanes, r.dispatch_clients, r.dispatch_traces)
                   for r in replies.values()),
            [(sp.trace_id, sp.ctx_parent, sp.origin,
              {k: v for k, v in sp.attrs.items() if k != "seconds"}) for sp in marks])
    assert got["port"] == got["ref"]
    assert [m[0] for m in got["port"][1]] == ["aa00000000000001", "bb00000000000002"]


# --- export formats ---------------------------------------------------------------


def test_exports_match_the_references():
    def record(tr):
        tracer = tr.Tracer(capacity=3)
        with tracer.span("crypto.batch_verify", lanes=4) as sp:
            with tracer.span("ed25519.prepare", lanes=4):
                pass
            sp.set(impl="x")
        with pytest.raises(ValueError), tracer.span("ed25519.execute"):
            raise ValueError("launch failed")
        tracer.mark("sidecar.dispatch", ctx=tr.TraceContext("0102030405060708", 4, "n"),
                    lanes=4)
        return tracer

    ref, port = record(jtrace), record(trace)

    def lines(text):
        # times and ids differ from run to run; the rest is the record
        return [{k: v for k, v in json.loads(line).items()
                 if k not in ("start_s", "dur_s", "tid", "id", "parent")}
                for line in text.splitlines()]

    assert lines(trace.to_jsonl(port.snapshot())) == lines(jtrace.to_jsonl(ref.snapshot()))
    assert trace.to_jsonl([]) == jtrace.to_jsonl([]) == ""
    ref_events = jtrace.to_chrome_trace(ref.snapshot())["traceEvents"]
    port_events = trace.to_chrome_trace(port.snapshot())["traceEvents"]
    assert [(e["name"], e["ph"], sorted(e["args"])) for e in port_events] == \
        [(e["name"], e["ph"], sorted(e["args"])) for e in ref_events]
    assert port.dropped == ref.dropped == 1
    assert {k: v for k, v in port.summary().items() if k != "spans"} == \
        {k: v for k, v in ref.summary().items() if k != "spans"}
    assert sorted(port.summary()["spans"]) == sorted(ref.summary()["spans"])
    assert [sp.attrs for sp in port.snapshot()] == [sp.attrs for sp in ref.snapshot()]


def test_disabled_tracing_records_nothing_and_keeps_results():
    pks, msgs, sigs, powers = _ed_lanes(4, 66)
    from tmtpu_torch.gpu import sharding

    trace.drain()
    trace.set_enabled(False)
    try:
        mask, tally = sharding.batch_verify_tally(pks, msgs, sigs, powers, device=CPU)
        assert trace.mark("sidecar.dispatch") is None
    finally:
        trace.set_enabled(True)
    assert trace.drain() == [] and mask.all() and tally == sum(powers)


def test_a_failed_launch_raises_through_its_span(monkeypatch):
    """No span or metric update catches a kernel's failure: it raises
    through ``ed25519.execute`` (flagged ``error``) and its parent, and no
    batch is observed."""
    from tmtpu_torch.gpu import sharding

    def broken(*args):
        raise RuntimeError("ed25519_verify launch failed: cudaError 700")

    monkeypatch.setattr(sharding, "verify_tally_step_kernel", broken)
    pks, msgs, sigs, powers = _ed_lanes(4, 67)
    count = metrics.crypto_batch_size.totals(curve="ed25519", backend="cpu")[0]
    trace.drain()
    with pytest.raises(RuntimeError, match="cudaError 700"):
        sharding.batch_verify_tally(pks, msgs, sigs, powers, device=CPU)
    spans = {sp.name: sp.attrs for sp in trace.drain()}
    assert spans["ed25519.execute"]["error"] is True
    assert spans["crypto.batch_verify_tally"]["error"] is True
    assert "ed25519.readback" not in spans
    assert metrics.crypto_batch_size.totals(curve="ed25519", backend="cpu")[0] == count

