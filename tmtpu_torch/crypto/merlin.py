"""Merlin transcripts over STROBE-128 and Keccak-f[1600], in pure Python:
the port's own copy of the reference package's ``crypto/merlin.py``.

sr25519 (schnorrkel) derives its challenge scalar from a merlin transcript
(reference crypto/sr25519/pubkey.go:50 via go-schnorrkel and gtank/merlin).
The layout follows merlin's strobe.rs and transcript.rs: STROBE-128
initialised with "STROBEv1.0.2", R = 166, meta-AD framing, and the
transcript ops ``append_message`` and ``challenge_bytes``, plus the witness
rng that signing uses for its nonce. The port's sr25519 host prep walks one
transcript per lane with it (``gpu/sr_verify.py``).
"""

from __future__ import annotations

# --- keccak-f[1600] ---------------------------------------------------------

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_MASK = (1 << 64) - 1


def _rol(v: int, n: int) -> int:
    return ((v << n) | (v >> (64 - n))) & _MASK


def keccak_f1600(state: bytearray) -> None:
    """In-place permutation on 200 bytes (little-endian lanes)."""
    a = [[int.from_bytes(state[8 * (x + 5 * y):8 * (x + 5 * y) + 8],
                         "little") for y in range(5)] for x in range(5)]
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rol(a[x][y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & _MASK
                                     & b[(x + 2) % 5][y])
        # iota
        a[0][0] ^= rc
    for x in range(5):
        for y in range(5):
            state[8 * (x + 5 * y):8 * (x + 5 * y) + 8] = \
                a[x][y].to_bytes(8, "little")


# --- STROBE-128 (merlin strobe.rs subset) -----------------------------------

_STROBE_R = 166
_FLAG_I = 1
_FLAG_A = 1 << 1
_FLAG_C = 1 << 2
_FLAG_T = 1 << 3
_FLAG_M = 1 << 4
_FLAG_K = 1 << 5


class Strobe128:
    def __init__(self, protocol_label: bytes):
        self.state = bytearray(200)
        self.state[0:6] = bytes([1, _STROBE_R + 2, 1, 0, 1, 96])
        self.state[6:18] = b"STROBEv1.0.2"
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    def clone(self) -> "Strobe128":
        s = Strobe128.__new__(Strobe128)
        s.state = bytearray(self.state)
        s.pos = self.pos
        s.pos_begin = self.pos_begin
        s.cur_flags = self.cur_flags
        return s

    # ops
    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_M | _FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(_FLAG_I | _FLAG_A | _FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_A | _FLAG_C, more)
        self._overwrite(data)

    # internals
    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[_STROBE_R + 1] ^= 0x80
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        for b in data:
            self.state[self.pos] ^= b
            self.pos += 1
            if self.pos == _STROBE_R:
                self._run_f()

    def _overwrite(self, data: bytes) -> None:
        for b in data:
            self.state[self.pos] = b
            self.pos += 1
            if self.pos == _STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == _STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if self.cur_flags != flags:
                raise ValueError("strobe: op flag mismatch on continuation")
            return
        if flags & _FLAG_T:
            raise ValueError("strobe: transport ops unsupported")
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = bool(flags & (_FLAG_C | _FLAG_K))
        if force_f and self.pos != 0:
            self._run_f()


# --- merlin transcript ------------------------------------------------------

_MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"


def _le32(n: int) -> bytes:
    return n.to_bytes(4, "little")


class Transcript:
    def __init__(self, label: bytes):
        self.strobe = Strobe128(_MERLIN_PROTOCOL_LABEL)
        self.append_message(b"dom-sep", label)

    def clone(self) -> "Transcript":
        t = Transcript.__new__(Transcript)
        t.strobe = self.strobe.clone()
        return t

    def append_message(self, label: bytes, message: bytes) -> None:
        self.strobe.meta_ad(label + _le32(len(message)), False)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, n: int) -> None:
        self.append_message(label, n.to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label + _le32(n), False)
        return self.strobe.prf(n, False)

    # witness rng (merlin transcript.rs TranscriptRngBuilder): used by
    # schnorrkel for signing nonces. rng_bytes stands in for the OS rng —
    # passing a deterministic value yields deterministic (still valid and
    # interoperable-to-verify) signatures.
    def witness_bytes(self, label: bytes, witness: bytes, n: int,
                      rng_bytes: bytes = b"\x00" * 32) -> bytes:
        s = self.strobe.clone()
        s.meta_ad(label + _le32(len(witness)), False)
        s.key(witness, False)
        # rng finalize: key in the external randomness
        s.meta_ad(b"rng", False)
        s.key(rng_bytes[:32].ljust(32, b"\x00"), False)
        s.meta_ad(_le32(n), False)
        return s.prf(n, False)
