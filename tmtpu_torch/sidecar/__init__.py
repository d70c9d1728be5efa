"""The verification sidecar daemon on the CUDA card: the port of
``tmtpu/sidecar/``.

One daemon process owns the card for a whole host and serves batched
ed25519, sr25519 and secp256k1 verification, and verify + voting-power
tally, to every node process over the reference's length-prefixed wire
protocol, so an unmodified tmtpu node with ``crypto_backend=sidecar``
verifies on the card. Concurrent clients' lanes coalesce into joint
dispatches of the port's batch verifier, and each client gets its exact
slice of the joint mask.

- ``protoio.py``, ``protocol.py``: the port's own copy of the codec, the
  same bytes on the wire, plus a columnar path for VerifyRequest.
- ``coalescer.py``: per-curve queues, admission control, whole-request
  joint dispatches under an adaptive gather window.
- ``server.py``: the daemon (listener, handshake, Verify / Ping / Stats,
  drain and stop), its engine ``crypto/batch.py::verify_lanes`` on the
  card, and ``warm()``.
- ``client.py``: the port's own client.

Run it with ``python -m tmtpu_torch sidecar --addr unix:///path/sock``.
"""
