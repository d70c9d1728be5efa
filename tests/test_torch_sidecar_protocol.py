"""The port's sidecar codec (tmtpu_torch/sidecar/{protoio,protocol}.py)
against the reference's (tmtpu/sidecar/protocol.py), on the CPU: equal
bytes for every message type both ways, the reference tests' fuzz (byte
soup, bit flips, truncations, oversized frames, unknown types) with the
same outcome on both sides and only ProtocolError / EOFError raised, and
the columnar VerifyRequest path (``decode_verify_columns``,
``encode_verify_frame``) against the generic codec on seeded random
requests whose Lane fields come shuffled, repeated, missing and mixed with
unknown ones. Every columnar case runs twice, under the C walk of the
frame (``native.walk_verify``) and under the plain Python walk alone, and
each result is held against the Python walk's own: the same columns, or
the same ProtocolError message."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

from tmtpu.sidecar import protocol as ref
from tmtpu_torch.sidecar import protocol as proto
from tmtpu_torch.sidecar.protoio import encode_uvarint, encode_varint, tag


SAMPLES = {
    "Hello": dict(version=2, client_id="node-7", features=["tally", "k1"]),
    "HelloAck": dict(version=2, server_id="daemon-1", backend="gpu",
                     max_lanes=40960, max_frame_bytes=8 * 1024 * 1024),
    "VerifyRequest": dict(
        request_id=2**53, curve="ed25519", tally=True, deadline_ms=1500,
        lanes=[("\x01" * 32, b"vote-bytes", "\x02" * 64, 1000),
               ("\x03" * 32, b"", "\x04" * 64, 0),
               ("", b"m", "", -(2**63))],
        trace_ctx=b"\x01" + b"\x07" * 18),
    "VerifyResponse": dict(
        request_id=2**53, status=ref.STATUS_OK, mask=b"\x05", lane_count=3,
        tallied=-3000, dispatch_id=17, dispatch_lanes=4096, dispatch_clients=3,
        error="e", dispatch_traces=2),
    "Ping": dict(nonce=0xDEADBEEF),
    "Pong": dict(nonce=0xDEADBEEF, backend="cpu", uptime_ms=123456),
    "StatsRequest": dict(),
    "StatsResponse": dict(stats_json=b'{"uptime_s": 1}'),
    "ErrorReply": dict(request_id=9, code=ref.ERR_VERSION, message="speak v1"),
}


def _build(module, name):
    """The sample message ``name`` as a message of ``module``'s codec."""
    kwargs = dict(SAMPLES[name])
    if name == "VerifyRequest":
        kwargs["lanes"] = [module.Lane(pub_key=pk.encode("latin-1"), msg=m,
                                       sig=s.encode("latin-1"), power=p)
                           for pk, m, s, p in kwargs["lanes"]]
    return getattr(module, name)(**kwargs)


def _values(msg):
    """A decoded message as plain values (lanes as tuples)."""
    out = {}
    for _, name, _ in msg.FIELDS:
        v = getattr(msg, name)
        if name == "lanes":
            v = [(ln.pub_key, ln.msg, ln.sig, ln.power) for ln in v]
        out[name] = v
    return out


def test_constants_and_registry_match_reference():
    assert proto.PROTOCOL_VERSION == ref.PROTOCOL_VERSION == 2
    assert proto.SUPPORTED_VERSIONS == ref.SUPPORTED_VERSIONS == (1, 2)
    assert proto.TRACE_CTX_MIN_VERSION == ref.TRACE_CTX_MIN_VERSION
    assert proto.DEFAULT_MAX_FRAME_BYTES == ref.DEFAULT_MAX_FRAME_BYTES
    assert proto.STATUS_NAMES == ref.STATUS_NAMES
    for name in ("STATUS_OK", "STATUS_OVERLOADED", "STATUS_BACKEND_DOWN", "STATUS_BAD_REQUEST",
                 "STATUS_SHUTTING_DOWN", "ERR_VERSION", "ERR_PROTOCOL", "ERR_INTERNAL"):
        assert getattr(proto, name) == getattr(ref, name), name
    assert {tb: cls.__name__ for tb, cls in proto.MESSAGE_TYPES.items()} == \
        {tb: cls.__name__ for tb, cls in ref.MESSAGE_TYPES.items()}
    def spec_names(fields):  # message classes by name
        return [(fn, name, spec if not isinstance(spec, tuple) else
                 (spec[0], spec[1] if isinstance(spec[1], str) else
                  (spec[1][0], spec[1][1].__name__)))
                for fn, name, spec in fields]

    for tb, cls in proto.MESSAGE_TYPES.items():
        assert spec_names(cls.FIELDS) == spec_names(ref.MESSAGE_TYPES[tb].FIELDS), cls.__name__
    assert set(SAMPLES) == {cls.__name__ for cls in proto.MESSAGE_TYPES.values()}


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_every_message_type_equal_bytes_both_ways(name):
    port_msg, ref_msg = _build(proto, name), _build(ref, name)
    frame = proto.encode_frame(port_msg)
    assert frame == ref.encode_frame(ref_msg)
    # each side reads the other's frame
    from_ref = proto.FrameReader(io.BytesIO(ref.encode_frame(ref_msg))).read_msg()
    from_port = ref.FrameReader(io.BytesIO(frame)).read_msg()
    assert type(from_ref).__name__ == type(from_port).__name__ == name
    assert _values(from_ref) == _values(from_port) == _values(port_msg)
    assert from_ref.encode() == from_port.encode()


def test_stream_of_frames_in_order():
    buf = io.BytesIO()
    for cls in proto.MESSAGE_TYPES.values():
        proto.write_frame(buf, _build(proto, cls.__name__))
    buf.seek(0)
    rd = proto.FrameReader(buf)
    for cls in proto.MESSAGE_TYPES.values():
        assert type(rd.read_msg()) is cls
    with pytest.raises(EOFError):
        rd.read_msg()


def test_mask_codec_matches_reference():
    rng = np.random.default_rng(3)
    for n in (0, 1, 7, 8, 9, 63, 64, 65, 1000):
        mask = [bool(b) for b in rng.integers(0, 2, n)]
        packed = proto.pack_mask(mask)
        assert packed == ref.pack_mask(mask)
        assert proto.unpack_mask(packed, n) == mask
        blob = rng.integers(0, 256, (n + 7) // 8 + 2, dtype=np.uint8).tobytes()
        assert proto.unpack_mask(blob, n) == ref.unpack_mask(blob, n)
    with pytest.raises(proto.ProtocolError):
        proto.unpack_mask(b"\x01", 9)


def test_parse_addr_matches_reference():
    for good in ("unix:///tmp/x.sock", "tcp://127.0.0.1:7777", "tcp://[::1]:0"):
        assert proto.parse_addr(good) == ref.parse_addr(good)
    for bad in ("", "unix://", "tcp://nohost", "tcp://:9", "http://x:1", "/tmp/x.sock"):
        with pytest.raises(ValueError):
            proto.parse_addr(bad)


# --- fuzz: the same outcome as the reference, and only clean errors -----------


def _outcome(module, blob, max_frame_bytes=4096, reads=4):
    """What reading up to ``reads`` frames from ``blob`` gives: the decoded
    messages' values, then the kind of error that ended it."""
    rd = module.FrameReader(io.BytesIO(blob), max_frame_bytes=max_frame_bytes)
    got = []
    try:
        for _ in range(reads):
            msg = rd.read_msg()
            got.append((type(msg).__name__, _values(msg)))
    except EOFError:
        got.append("EOFError")
    except module.ProtocolError:
        got.append("ProtocolError")
    return got


# the C walk's columns, kept whichever walk a case runs
_c_walk = proto._native_columns


@pytest.fixture(params=["native", "python"])
def walk(request, monkeypatch):
    """Which walk reads the columnar cases: the C walk (deferring to the
    Python walk where it must, as the daemon runs it), or the plain Python
    walk alone."""
    if request.param == "python":
        monkeypatch.setattr(proto, "_native_columns", lambda body: None)
    return request.param


def _python_walk(body):
    """The plain Python walk's outcome: its columns, or the message of the
    ProtocolError it raises."""
    try:
        return proto._walk_verify_request(body, 1)
    except (EOFError, ValueError, UnicodeDecodeError) as exc:
        return f"malformed VerifyRequest payload: {exc}"


def _columnar(body):
    """``decode_verify_walk``'s outcome: (columns or the ProtocolError's
    message, the walk that read the body)."""
    try:
        return proto.decode_verify_walk(body)
    except proto.ProtocolError as exc:
        return str(exc), "python"


def _verify_body_agrees(body):
    """On a frame body of type VerifyRequest, the columnar decode gives
    the generic decode's columns, or both raise ProtocolError; either way
    exactly what the Python walk gives, and the C walk returns columns
    only where the Python walk does (else it defers)."""
    want_py = _python_walk(body)
    got, used = _columnar(body)
    assert got == want_py
    native_cols = _c_walk(body)
    assert native_cols is None or native_cols == want_py
    engaged = native_cols is not None and proto._native_columns is _c_walk
    assert used == ("native" if engaged else "python")
    try:
        want = proto.columns_of(proto.decode_frame(body))
    except proto.ProtocolError:
        assert isinstance(got, str)
        return False
    assert got == want
    return True


def _frames():
    return {name: proto.encode_frame(_build(proto, name)) for name in SAMPLES}


def _prefix_len(frame):
    """Bytes of a frame's uvarint length prefix."""
    return next(i for i, b in enumerate(frame) if b < 0x80) + 1


def test_fuzz_random_byte_soup(walk):
    rng = np.random.default_rng(20260806)
    blobs = [b"", b"\x00", b"\xff" * 16, b"\x02\x03\x2a"]
    for _ in range(300):
        blobs.append(rng.integers(0, 256, int(rng.integers(1, 200)), dtype=np.uint8).tobytes())
    for blob in blobs:
        assert _outcome(proto, blob) == _outcome(ref, blob)
        if blob and blob[0] == proto.VERIFY_REQUEST_TYPE:
            _verify_body_agrees(blob)


@pytest.mark.parametrize(("name", "walk"), [
    ("VerifyRequest", "native"), ("VerifyRequest", "python"),
    ("VerifyResponse", "native"), ("Hello", "native"), ("ErrorReply", "native"),
], ids=["VerifyRequest-native", "VerifyRequest-python", "VerifyResponse", "Hello", "ErrorReply"],
    indirect=["walk"])
def test_fuzz_bit_flips_in_valid_frames(name, walk):
    rng = np.random.default_rng(7)
    frame = bytearray(_frames()[name])
    for _ in range(120):
        pos = int(rng.integers(0, len(frame)))
        mut = bytes(frame[:pos]) + bytes([int(rng.integers(0, 256))]) + bytes(frame[pos + 1:])
        assert _outcome(proto, mut) == _outcome(ref, mut)
        body = mut[_prefix_len(frame):]
        if body and body[0] == proto.VERIFY_REQUEST_TYPE:
            _verify_body_agrees(body)


def test_truncated_frames_raise_cleanly(walk):
    frame = _frames()["VerifyRequest"]
    for cut in range(len(frame)):
        got = _outcome(proto, frame[:cut], reads=1)
        assert got in (["EOFError"], ["ProtocolError"])
        assert got == _outcome(ref, frame[:cut], reads=1)
    body = frame[_prefix_len(frame):]
    assert _verify_body_agrees(body)
    for cut in range(1, len(body)):
        _verify_body_agrees(body[:cut])


def test_oversized_and_unknown_frames_rejected():
    frame = _frames()["VerifyRequest"]
    for mfb in (8, len(frame) - _prefix_len(frame) - 1):
        with pytest.raises(proto.ProtocolError):
            proto.FrameReader(io.BytesIO(frame), max_frame_bytes=mfb).read_msg()
    # a length prefix claiming a terabyte is rejected from the prefix alone
    with pytest.raises(proto.ProtocolError):
        proto.FrameReader(io.BytesIO(encode_uvarint(1 << 40) + b"\x01")).read_msg()
    with pytest.raises(proto.ProtocolError):
        proto.decode_frame(b"")
    for tb in (0, 10, 0x7F, 0xFF):
        with pytest.raises(proto.ProtocolError):
            proto.decode_frame(bytes([tb]) + b"\x01\x02")
    with pytest.raises(proto.ProtocolError):
        proto.decode_verify_columns(bytes([proto.TYPE_BYTES[proto.Ping]]))


# --- the columnar VerifyRequest path ------------------------------------------


def _field(rng, fn, value=None):
    """One encoded field ``fn``: bytes fields 1-3 and 6 length-delimited,
    varint fields as varints, an unknown one with a random wire type; now
    and then a known field under a wire type that is not its own."""
    if value is None:
        wt = int(rng.choice([0, 1, 2, 5]))
        payload = {0: lambda: encode_uvarint(int(rng.integers(0, 2**40))),
                   1: lambda: rng.bytes(8), 5: lambda: rng.bytes(4),
                   2: lambda: (lambda b: encode_uvarint(len(b)) + b)(
                       rng.bytes(int(rng.integers(0, 20))))}[wt]()
        return tag(fn, wt) + payload
    if isinstance(value, bytes):
        wt = 0 if rng.random() < 0.03 else 2
        return tag(fn, wt) + encode_uvarint(len(value)) + value
    wt = 2 if rng.random() < 0.03 else 0
    return tag(fn, wt) + encode_varint(value)


def _random_lane(rng):
    fields = []
    for fn, make in ((1, lambda: rng.bytes(int(rng.choice([0, 32, 33, 31])))),
                     (2, lambda: rng.bytes(int(rng.integers(0, 300)))),
                     (3, lambda: rng.bytes(int(rng.choice([0, 64, 63])))),
                     (4, lambda: int(rng.choice([0, 3, 127, 128, 2**60, -1, -(2**63),
                                                 2**63 - 1, int(rng.integers(0, 2**62))])))):
        for _ in range(int(rng.choice([0, 1, 1, 1, 2]))):  # missing, once or repeated
            fields.append(_field(rng, fn, make()))
    for _ in range(int(rng.choice([0, 0, 1, 2]))):
        fields.append(_field(rng, int(rng.choice([5, 6, 15, 16, 100, 2**20]))))
    rng.shuffle(fields)
    body = b"".join(fields)
    return tag(5, 2) + encode_uvarint(len(body)) + body


def _random_request(rng, n_lanes):
    top = [_random_lane(rng) for _ in range(n_lanes)]
    for fn, make in ((1, lambda: int(rng.integers(0, 2**63))),
                     (2, lambda: str(rng.choice(["ed25519", "sr25519", "secp256k1", "é"]))
                      .encode("utf-8")),
                     (3, lambda: int(rng.integers(0, 3))),
                     (4, lambda: int(rng.integers(0, 2**32))),
                     (6, lambda: rng.bytes(int(rng.integers(0, 30))))):
        for _ in range(int(rng.choice([0, 1, 1, 2]))):
            top.append(_field(rng, fn, make()))
    for _ in range(int(rng.choice([0, 1, 2]))):
        top.append(_field(rng, int(rng.choice([7, 9, 31, 1000]))))
    order = rng.permutation(len(top))
    return bytes([proto.VERIFY_REQUEST_TYPE]) + b"".join(top[i] for i in order)


@pytest.mark.parametrize("seed", range(6))
def test_columnar_decode_equals_generic_on_random_requests(seed, walk):
    rng = np.random.default_rng(1000 + seed)
    decoded = native = 0
    for _ in range(60):
        body = _random_request(rng, int(rng.integers(0, 12)))
        if _verify_body_agrees(body):
            decoded += 1
            native += proto.decode_verify_walk(body)[1] == "native"
            # and the reference's generic decode reads the same
            want = ref.decode_frame(body)
            got = proto.decode_verify_columns(body)
            assert (got.request_id, got.curve, got.tally, got.deadline_ms, got.trace_ctx) == \
                (want.request_id, want.curve, want.tally, want.deadline_ms, want.trace_ctx)
            assert list(zip(got.pks, got.msgs, got.sigs, got.powers)) == \
                [(ln.pub_key, ln.msg, ln.sig, ln.power) for ln in want.lanes]
        # cuts and flips of the same body
        for _ in range(4):
            cut = int(rng.integers(1, len(body) + 1))
            _verify_body_agrees(body[:cut])
            pos = int(rng.integers(1, len(body)))
            _verify_body_agrees(body[:pos] + bytes([int(rng.integers(0, 256))]) + body[pos + 1:])
    assert decoded >= 40
    # the C walk defers only on repeated curves with a non-ASCII earlier one
    assert native >= (decoded * 3) // 4 if walk == "native" else native == 0


@pytest.mark.parametrize("seed", range(3))
def test_encode_verify_frame_equals_generic(seed, walk):
    rng = np.random.default_rng(2000 + seed)
    for _ in range(40):
        n = int(rng.integers(0, 10))
        pks = [rng.bytes(int(rng.choice([0, 32, 33]))) for _ in range(n)]
        msgs = [rng.bytes(int(rng.choice([0, 5, 127, 128, 300, 16383, 16384, 20000])))
                for _ in range(n)]
        sigs = [rng.bytes(int(rng.choice([0, 64]))) for _ in range(n)]
        powers = [int(rng.choice([0, 1, 3, 16383, 16384, 2**60, -5, -(2**63), 2**63 - 1]))
                  for _ in range(n)]
        head = dict(request_id=int(rng.integers(0, 2**63)), curve=str(rng.choice(["", "ed25519"])),
                    tally=bool(rng.integers(0, 2)), deadline_ms=int(rng.integers(0, 2**20)))
        ctx = rng.bytes(int(rng.choice([0, 19, 40])))
        frame = proto.encode_verify_frame(*head.values(), pks, msgs, sigs, powers, trace_ctx=ctx)
        lanes = [ref.Lane(pub_key=a, msg=b, sig=c, power=d)
                 for a, b, c, d in zip(pks, msgs, sigs, powers)]
        assert frame == ref.encode_frame(ref.VerifyRequest(lanes=lanes, trace_ctx=ctx, **head))
        body = proto.FrameReader(io.BytesIO(frame), max_frame_bytes=1 << 24).read_body()
        assert proto.decode_verify_walk(body) == (proto.VerifyColumns(
            *head.values(), ctx, pks, msgs, sigs, powers), walk)


def _lane_of(body):
    return tag(5, 2) + encode_uvarint(len(body)) + body


@pytest.mark.parametrize("lane_body", [
    b"\x80",                        # a tag cut at the lane's end
    b"\x81",                        # the same, of wire type 1 (nothing to read)
    b"\x0a\x80",                    # a key length cut at the lane's end
    b"\x0a\x05abc",                 # a key cut at the lane's end
    b"\x20\xff",                    # a power cut at the lane's end
    b"\x28\x80",                    # an unknown varint field cut at the lane's end
    b"\x2a\x80",                    # an unknown bytes field's length cut there
    b"\x29" + b"\x00" * 3,          # an unknown fixed64 running past the lane
    b"\x2d\x00",                    # an unknown fixed32 running past the lane
    b"\x0b\x01",                    # wire type 3: unsupported
    b"\x0a\x02pk\x0a\x01k\x20\x05\x20\x06",  # repeats: the last one wins
], ids=["tag", "fixed64 tag", "key length", "key", "power", "unknown varint", "unknown length",
        "fixed64 past", "fixed32 past", "wire type 3", "repeats"])
def test_columnar_decode_stays_within_each_lane(lane_body, walk):
    """Each lane is read within its own length, as the generic decode
    reads its sub-message: whatever follows the lane in the frame (here a
    second lane and a request id) never completes a field cut at its end."""
    body = (bytes([proto.VERIFY_REQUEST_TYPE]) + _lane_of(lane_body)
            + _lane_of(b"\x0a\x01x\x20\x07") + tag(1, 0) + encode_uvarint(9))
    _verify_body_agrees(body)


# --- the C walk against the Python walk ---------------------------------------


def test_c_walk_equals_python_walk_on_10000_lanes():
    """A 10,000-lane body at the wire's edges: powers at the int64 bounds
    and either side of one varint byte, messages either side of one and
    two length bytes, keys of one width and of mixed widths, empty ones
    among them."""
    rng = np.random.default_rng(15)
    n = 10_000
    edge_powers = [0, 127, 128, 2**63 - 1, -1, -(2**63)]
    powers = [edge_powers[i % 6] if i % 3 else int(rng.integers(1, 10**12)) for i in range(n)]
    msgs = [rng.bytes([127, 128, 16_384, 110, 0][i % 5] if i % 7 else int(rng.integers(0, 300)))
            for i in range(n)]
    for pk_widths in ([32], [32, 33, 0]):
        pks = [rng.bytes(pk_widths[i % len(pk_widths)]) for i in range(n)]
        sigs = [rng.bytes(64) for _ in range(n)]
        frame = proto.encode_verify_frame(2**63 + 5, "ed25519", True, 900, pks, msgs, sigs,
                                          powers, trace_ctx=b"\x01" * 19)
        body = proto.FrameReader(io.BytesIO(frame), max_frame_bytes=1 << 26).read_body()
        got, used = proto.decode_verify_walk(body)
        assert used == "native"
        want = proto._walk_verify_request(body, 1)
        for field in proto.VerifyColumns._fields:
            assert getattr(got, field) == getattr(want, field), field
        assert got == proto.VerifyColumns(2**63 + 5, "ed25519", True, 900, b"\x01" * 19,
                                          pks, msgs, sigs, powers)
        assert all(type(v) is bytes for col in (got.pks, got.msgs, got.sigs) for v in col)


_BIG = encode_uvarint(2**64 + 3)  # 10 bytes, over 64 bits
_LANE = _lane_of(b"\x0a\x02pk\x12\x03msg\x1a\x03sig\x20\x05")


@pytest.mark.parametrize("body", [
    tag(1, 0) + _BIG + _LANE,
    _LANE + _lane_of(b"\x20" + _BIG),
    _LANE + _lane_of(b"\x20" + encode_uvarint(2**64 - 1)),
    _LANE + _lane_of(b"\x0a\x01k" + tag(9, 0) + _BIG),
    tag(4, 0) + b"\x80" * 10 + b"\x00" + _LANE,
    tag(2, 2) + b"\x02\xff\xfe" + _LANE,
    tag(2, 2) + b"\x02\xc3\xa9" + tag(2, 2) + b"\x07ed25519" + _LANE,
    tag(2, 2) + b"\x02\xff\xfe" + tag(2, 2) + b"\x07ed25519" + _LANE,
    _LANE + tag(9, 3) + b"\x00",
    _LANE + _lane_of(b"\x0b\x01"),
    _LANE + _lane_of(b"\x0c"),
    tag(7, 6) + _LANE,
], ids=["request_id over 2^64", "power over 2^64", "power 2^64-1 wraps", "unknown over 2^64",
        "deadline of 11 bytes", "curve not utf-8", "curve repeated, non-ascii first",
        "curve repeated, not utf-8 first", "wire type 3", "lane wire type 3",
        "lane wire type 4", "wire type 6"])
def test_bodies_the_c_walk_defers(body):
    """Bodies the C walk does not take: the decode gives the Python walk's
    columns or its exact ProtocolError. A power of 2^64 - 1 fits the C
    walk's 64 bits, and it reads -1 as the Python walk does."""
    body = bytes([proto.VERIFY_REQUEST_TYPE]) + body
    fits = body.endswith(_lane_of(b"\x20" + encode_uvarint(2**64 - 1)))
    assert (_c_walk(body) is not None) == fits
    _verify_body_agrees(body)
    if fits:
        assert proto.decode_verify_columns(body).powers == [5, -1]


def test_every_cut_of_a_full_body():
    """A body with every top-level field and lane field, cut at every byte:
    the C walk takes a cut only where the Python walk decodes it, and the
    decode gives the Python walk's columns or its exact error."""
    lanes = [(bytes(range(32)), bytes(range(130)), bytes(range(64)), -7),
             (b"\x05" * 32, b"", b"\x06" * 64, 2**62)]
    frame = proto.encode_verify_frame(300, "sr25519", True, 1500, *zip(*lanes),
                                      trace_ctx=b"\x01" * 19)
    body = proto.FrameReader(io.BytesIO(frame)).read_body()
    taken = 0
    for cut in range(1, len(body) + 1):
        _verify_body_agrees(body[:cut])
        taken += _c_walk(body[:cut]) is not None
    assert taken >= 4  # the whole body and the cuts at its top-level field ends


def test_encoding_needs_no_c_build():
    """Importing the codec and encoding a frame load nothing of the C host
    prep: a client process needs no C compiler."""
    code = ("import sys; from tmtpu_torch.sidecar import protocol as p; "
            "p.encode_verify_frame(1, 'ed25519', True, 0, [b'k'], [b'm'], [b's'], [1]); "
            "assert 'tmtpu_torch.native' not in sys.modules, 'native loaded'")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True)
