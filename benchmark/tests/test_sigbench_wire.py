"""The benchmark's frozen codec against the daemon's, byte for byte."""

import random
import socket
import threading

import pytest

from benchmark import control, wire
from tmtpu_torch.sidecar import protocol as proto


def _lanes(n, seed):
    rng = random.Random(seed)
    powers = [0, 1, 127, 128, 16383, 16384, -1, -(2 ** 40), 2 ** 62, 2 ** 63 - 1]
    return ([rng.randbytes(32) for _ in range(n)],
            [rng.randbytes(rng.choice([0, 1, 110, 127, 128, 300])) for _ in range(n)],
            [rng.randbytes(64) for _ in range(n)],
            [rng.choice(powers) for _ in range(n)])


@pytest.mark.parametrize("n", [1, 3, 200])
@pytest.mark.parametrize("rid,tally,deadline", [(1, True, 10000), (2 ** 40, False, 0)])
def test_verify_frame_is_the_daemons(n, rid, tally, deadline):
    pks, msgs, sigs, powers = _lanes(n, n)
    want = proto.encode_verify_frame(rid, "ed25519", tally, deadline, pks, msgs, sigs, powers)
    lanes = b"".join(wire.lane_blob(*lane) for lane in zip(pks, msgs, sigs, powers))
    assert wire.verify_frame(rid, "ed25519", tally, deadline, lanes) == want
    cols = proto.decode_verify_columns(_body(want))
    assert (cols.pks, cols.msgs, cols.sigs, cols.powers) == (pks, msgs, sigs, powers)
    rid2, curve, tally2, got = control.decode_verify_request(_body(want))
    assert (rid2, curve, tally2) == (rid, "ed25519", tally)
    assert got == list(zip(pks, msgs, sigs, powers))


def _body(frame):
    n, pos = wire._read_uvarint(frame, 0)
    assert len(frame) == pos + n
    return frame[pos:]


def test_hello_and_stats_frames_are_the_daemons():
    hello = proto.Hello(version=proto.PROTOCOL_VERSION, client_id="node0",
                        features=["verify", "tally"])
    assert wire.hello_frame("node0") == proto.encode_frame(hello)
    assert wire.stats_frame() == proto.encode_frame(proto.StatsRequest())


@pytest.mark.parametrize("msg", [
    proto.VerifyResponse(request_id=7, status=0, mask=b"\x05\x80", lane_count=16,
                         tallied=-(2 ** 63), dispatch_id=3, dispatch_lanes=40,
                         dispatch_clients=4, error="", dispatch_traces=1),
    proto.VerifyResponse(request_id=2 ** 50, status=1, lane_count=9, error="queue full"),
    proto.HelloAck(version=2, server_id="s", backend="gpu", max_lanes=40960,
                   max_frame_bytes=8 << 20),
    proto.StatsResponse(stats_json=b'{"a": 1}'),
    proto.ErrorReply(request_id=1, code=2, message="bad"),
])
def test_replies_decode_as_the_daemon_wrote_them(msg):
    kind, fields = wire.decode_body(_body(proto.encode_frame(msg)))
    assert kind == proto.TYPE_BYTES[type(msg)]
    for name, value in fields.items():
        want = getattr(msg, name)
        assert value == (want.encode() if isinstance(want, str) else want), name


def test_control_reply_decodes_with_the_daemons_codec():
    frame = control.response_frame(9, [True, False, True] * 5, 12345, 4)
    msg = proto.decode_frame(_body(frame))
    assert (msg.request_id, msg.lane_count, msg.tallied, msg.dispatch_id) == (9, 15, 12345, 4)
    assert proto.unpack_mask(msg.mask, 15) == [True, False, True] * 5


@pytest.mark.parametrize("n", [1, 7, 8, 9, 10000])
def test_unpack_mask_is_the_daemons(n):
    rng = random.Random(n)
    mask = [rng.random() < 0.5 for _ in range(n)]
    packed = proto.pack_mask(mask)
    assert wire.unpack_mask(packed, n).tolist() == proto.unpack_mask(packed, n) == mask


def test_frame_socket_reads_frames_split_and_joined():
    a, b = socket.socketpair()
    try:
        frames = [proto.encode_frame(proto.StatsResponse(stats_json=b"x" * k))
                  for k in (0, 5, 200, 70000)]
        blob = b"".join(frames)
        reader = wire.FrameSocket(b)
        sender = threading.Thread(
            target=lambda: [a.sendall(blob[i:i + 333]) for i in range(0, len(blob), 333)])
        sender.start()
        for f in frames:
            assert reader.read_body() == _body(f)
        sender.join(timeout=10)
        assert not sender.is_alive()
    finally:
        a.close()
        b.close()
