"""The port's C host prep: ``hostprep.c`` built with the system C compiler
and bound with ctypes.

The counterpart of the reference package's native host prep, with its two
device-path entries, and the signature cache's store:

- ``prep_ed25519``: the lengths, s < L, A.y < p and h = SHA-512(R || A ||
  M) mod L per lane, written as the kernel's plane (ed25519 host prep,
  ``gpu/verify.py::prepare_batch_packed``);
- ``sr_challenges``: the merlin transcript walk of an sr25519 verify, k per
  lane (``gpu/sr_verify.py::prepare_sr_batch_packed``);
- ``prep_k1``: the checks, SHA-256 and the scalars u1, u2 mod n of a
  secp256k1 verify, the kernel's whole plane
  (``gpu/k1_verify.py::prepare_k1_batch_packed``);
- ``Store``: the sharded, lock-striped LRU set behind
  ``crypto/sigcache.py``, and ``resolve``, which computes a flush's cache
  keys (``sigcache.cache_key`` of every lane), looks them up in a store
  and folds the flush's repeated misses onto their first lane in one
  call; ``cache_keys`` is its key pass alone;
- ``walk_verify``: where each field of a sidecar VerifyRequest frame lies
  (``sidecar/protocol.py::decode_verify_columns``), or None where the
  frame needs the Python walk;
- ``reduce_mod_l_for_tests``, ``mod_n_for_tests``: the prep's arithmetic
  mod L and mod the secp256k1 order n alone, which the tests hold against
  Python's ``int``.

Keys, signatures and messages go in as columns (``crypto/lanes.py``: one
buffer and int64 [lo, hi) offsets a lane; a list of byte strings is joined
once into one), so a column over the sidecar's frame body reaches C as it
is.

The library is built at first use (``load``) into the gitignored
``tmtpu_torch/gpu/build/host/``, named by a hash of the source, the flags,
the compiler's path and version, and the machine and C library, so an
edit rebuilds, an unchanged tree reuses it, and a library built on another
machine is never loaded. There is no
fallback: without a C compiler, or when the build fails or a symbol is
missing, ``load`` raises with the compiler's message. Each entry runs on
``min(8, os.cpu_count())`` threads unless told otherwise; its bytes do not
depend on the thread count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading

import numpy as np

from tmtpu_torch.crypto import lanes

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "hostprep.c")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "gpu", "build", "host")
CFLAGS = ["-O2", "-shared", "-fPIC", "-pthread"]

_P = ctypes.c_void_p
_SIGNATURES = {
    # n, pks (buf, lo, hi), sigs (buf, lo, hi), msgs (buf, lo, hi), packed_out,
    # ok_out, nthreads
    "tmtpu_prep_ed25519": [ctypes.c_size_t, *[_P] * 11, ctypes.c_int],
    # n, pks, rs, msgs (buf, lo, hi), k_out, nthreads
    "tmtpu_sr_challenges": [ctypes.c_size_t, _P, _P, _P, _P, _P, _P, ctypes.c_int],
    # n, pks (buf, lo, hi), sigs (buf, lo, hi), msgs (buf, lo, hi), packed_out,
    # ok_out, nthreads -> -1 out of memory
    "tmtpu_prep_k1": ([ctypes.c_size_t, *[_P] * 11, ctypes.c_int], ctypes.c_int64),
    # store, n, names (buf, lo, hi), kind, pks, msgs, sigs (each buf, lo, hi),
    # keys_out, rep_out, nthreads -> hits
    "tmtpu_cache_resolve": ([_P, ctypes.c_size_t, *[_P] * 15, ctypes.c_int],
                            ctypes.c_int64),
    "tmtpu_cache_new": ([ctypes.c_int32, ctypes.c_int32], _P),
    "tmtpu_cache_free": [_P],
    "tmtpu_cache_clear": [_P],
    "tmtpu_cache_size": ([_P], ctypes.c_int64),
    "tmtpu_cache_resize": ([_P, ctypes.c_int32], ctypes.c_int64),
    # store, n, keys, hit_out -> hits
    "tmtpu_cache_lookup": ([_P, ctypes.c_size_t, _P, _P], ctypes.c_int64),
    # allow (1), forbid (0) or ask (-1) -> the SHA extensions in use
    "tmtpu_sha256_ni": ([ctypes.c_int], ctypes.c_int),
    # store, n, keys, &evicted -> inserted
    "tmtpu_cache_add": ([_P, ctypes.c_size_t, _P, _P], ctypes.c_int64),
    # n, in (n rows of 64 bytes), out (n rows of 32 bytes); the tests' entry
    "tmtpu_reduce_mod_l": [ctypes.c_size_t, _P, _P],
    # n, in (n rows of 64 bytes), red_out, inv_out (n rows of 32); the tests' entry
    "tmtpu_mod_n": [ctypes.c_size_t, _P, _P, _P],
    # body, len, cap, out [cap + 1, 7] -> lanes, -1 to defer to the Python walk
    "tmtpu_walk_verify": ([_P, ctypes.c_size_t, ctypes.c_int64, _P], ctypes.c_int64),
}

_lock = threading.Lock()
_lib = None


def _compiler() -> list:
    """The command that compiles C: ``cc``, else ``gcc``, else ``g++ -x c``."""
    for name in ("cc", "gcc"):
        found = shutil.which(name)
        if found:
            return [found]
    found = shutil.which("g++")
    if found:
        return [found, "-x", "c"]
    raise RuntimeError("no C compiler (cc, gcc or g++) on PATH: the port's "
                       "host prep is C and has no other version on the main path")


def _toolchain(cmd: list) -> str:
    """What a built library depends on besides its source and flags: the
    compiler's path and ``--version``, the machine and the C library."""
    proc = subprocess.run([*cmd, "--version"], capture_output=True, text=True)
    return "\n".join([" ".join(cmd), proc.stdout, platform.machine(),
                      " ".join(platform.libc_ver())])


def lib_path(src: str = SRC, out_dir: str = BUILD_DIR) -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    h.update(_toolchain(_compiler()).encode())
    with open(src, "rb") as fh:
        h.update(fh.read())
    return os.path.join(out_dir, f"hostprep-{h.hexdigest()[:16]}.so")


def build(src: str = SRC, out_dir: str = BUILD_DIR) -> str:
    """Compile ``src`` into ``out_dir`` unless it is built already; returns
    the library's path, raises with the compiler's output on failure. The
    library is compiled to a temporary name and renamed into place: the
    dynamic loader caches libraries by inode, so one rewritten in place
    could hand a process that loaded it before the stale code."""
    out = lib_path(src, out_dir)
    if os.path.exists(out):
        return out
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [*_compiler(), *CFLAGS, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"building the host prep failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The built library with every entry bound (built now if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, sig in _SIGNATURES.items():
                argtypes, restype = sig if isinstance(sig, tuple) else (sig, None)
                fn = getattr(lib, name)  # AttributeError: a missing symbol
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def _threads(nthreads) -> int:
    return min(8, os.cpu_count() or 1) if nthreads is None else int(nthreads)


def _rows(arr, n: int, width: int = 32) -> np.ndarray:
    """``arr`` as a C-contiguous [n, width] uint8 array; raises otherwise."""
    out = np.ascontiguousarray(arr, dtype=np.uint8)
    if out.shape != (n, width):
        raise ValueError(f"expected [{n}, {width}] uint8 rows, got shape {out.shape}")
    return out


def _column(parts, n: int):
    """``parts`` (a ``ByteColumn`` or byte strings) as the three pointers
    of a C column (buf, lo, hi); the arrays ride along so they outlive the
    call."""
    if len(parts) != n:
        raise ValueError(f"expected {n} byte strings, got {len(parts)}")
    col = lanes.byte_column(parts)
    arrays = (np.ascontiguousarray(col.buf, dtype=np.uint8),
              np.ascontiguousarray(col.lo, dtype=np.int64),
              np.ascontiguousarray(col.hi, dtype=np.int64))
    buf, lo, hi = arrays
    if buf.ndim != 1 or lo.shape != (n,) or hi.shape != (n,) or n and (
            lo.min() < 0 or (hi < lo).any() or hi.max() > len(buf)):
        raise ValueError("a column's offsets lie outside its buffer")
    return [a.ctypes.data for a in arrays], arrays


def _columns(n: int, *fields):
    """Every field's three pointers in order, and the arrays behind them."""
    ptrs, keep = [], []
    for parts in fields:
        p, arrays = _column(parts, n)
        ptrs += p
        keep.append(arrays)
    return ptrs, keep


def prep_ed25519(pks, msgs, sigs, nthreads=None):
    """The ed25519 host prep of every lane (``tmtpu_prep_ed25519``): pks,
    msgs and sigs are columns or byte strings. Returns (packed [128, B]
    uint8: pk | r | s | h as little-endian rows, h = SHA-512(R || A || M)
    mod L; ok bool [B], False where a length, s < L or A.y < p refuses the
    lane). A lane of the wrong length reads as zero key and signature
    bytes; s is zero where the lengths or s < L refuse the lane."""
    lib = load()
    n = len(sigs)
    ptrs, _keep = _columns(n, pks, sigs, msgs)
    packed = np.empty((128, n), dtype=np.uint8)
    ok = np.empty(n, dtype=np.uint8)
    lib.tmtpu_prep_ed25519(n, *ptrs, packed.ctypes.data, ok.ctypes.data, _threads(nthreads))
    return packed, ok.astype(bool)


def sr_challenges(pk_arr, r_arr, msgs, nthreads=None) -> np.ndarray:
    """The sr25519 verify challenge k = merlin challenge mod L for every
    lane. pk_arr, r_arr: [B, 32] uint8; msgs: a column or B byte strings.
    Returns k_arr [B, 32] uint8 little-endian."""
    lib = load()
    n = len(msgs)
    pk_arr, r_arr = _rows(pk_arr, n), _rows(r_arr, n)
    ptrs, _keep = _columns(n, msgs)
    k_out = np.empty((n, 32), dtype=np.uint8)
    lib.tmtpu_sr_challenges(n, pk_arr.ctypes.data, r_arr.ctypes.data, *ptrs,
                            k_out.ctypes.data, _threads(nthreads))
    return k_out


def prep_k1(pks, msgs, sigs, nthreads=None):
    """The secp256k1 host prep of every lane (``tmtpu_prep_k1``): pks,
    msgs and sigs are columns or byte strings. Returns (packed [168, B]
    uint8: pkx | u1 | u2 | r | rpn as big-endian rows, the prefix's parity
    in row 160, rows 161-167 zero; ok bool [B], False where a length, the
    prefix, x, r or s is refused, with dummy bytes in its column). A lane
    of the wrong length reads as zero key and signature bytes."""
    lib = load()
    n = len(sigs)
    ptrs, _keep = _columns(n, pks, sigs, msgs)
    packed = np.empty((168, n), dtype=np.uint8)
    ok = np.empty(n, dtype=np.uint8)
    if lib.tmtpu_prep_k1(n, *ptrs, packed.ctypes.data, ok.ctypes.data,
                         _threads(nthreads)) < 0:
        raise MemoryError("the secp256k1 host prep is out of memory")
    return packed, ok.astype(bool)


def reduce_mod_l_for_tests(values) -> np.ndarray:
    """The prep's reduction mod L alone, for the tests: ``values`` [n, 64]
    uint8, each row a 512-bit little-endian integer; returns [n, 32] uint8,
    each row reduced mod L, little-endian. No flush calls it."""
    rows = np.ascontiguousarray(values, dtype=np.uint8)
    if rows.ndim != 2 or rows.shape[1] != 64:
        raise ValueError(f"expected [n, 64] uint8 rows, got shape {rows.shape}")
    out = np.empty((len(rows), 32), dtype=np.uint8)
    load().tmtpu_reduce_mod_l(len(rows), rows.ctypes.data, out.ctypes.data)
    return out


def mod_n_for_tests(values):
    """The secp256k1 prep's arithmetic mod n alone, for the tests:
    ``values`` [m, 64] uint8, each row a 512-bit big-endian integer x (a
    product of two 256-bit values, say); returns (x mod n, (x mod n)^-1 or
    0 where x mod n is 0), each [m, 32] uint8 big-endian. No flush calls
    it."""
    rows = np.ascontiguousarray(values, dtype=np.uint8)
    if rows.ndim != 2 or rows.shape[1] != 64:
        raise ValueError(f"expected [m, 64] uint8 rows, got shape {rows.shape}")
    red, inv = (np.empty((len(rows), 32), dtype=np.uint8) for _ in range(2))
    load().tmtpu_mod_n(len(rows), rows.ctypes.data, red.ctypes.data, inv.ctypes.data)
    return red, inv


def _curve_names(types, n: int):
    """The flush's curve names as (a ``ByteColumn`` of the distinct names,
    int32 [n] name of each lane, or None where ``types`` is one name for
    every lane)."""
    if isinstance(types, str):
        return lanes.ByteColumn.join([types.encode()]), None
    if len(types) != n:
        raise ValueError(f"expected {n} curve names, got {len(types)}")
    index = {t: i for i, t in enumerate(dict.fromkeys(types))}
    kind = np.fromiter(map(index.__getitem__, types), dtype=np.int32, count=n)
    return lanes.ByteColumn.join([t.encode() for t in index]), kind


def resolve(store, types, pks, msgs, sigs, nthreads=None):
    """One flush's keys (``sigcache.cache_key`` of every lane; ``types``
    the curve names, one a lane, or one name for every lane; the rest
    columns or byte strings), looked up in order in ``store`` (a
    ``Store``; a hit refreshes its key; None: no lookups): (keys [B, 32]
    uint8, rep int32 [B]), rep -1 for a hit and else the flush's first
    lane that missed with the same key."""
    lib = load()
    n = len(sigs)
    names, kind = _curve_names(types, n)
    name_ptrs, name_keep = _columns(len(names), names)
    ptrs, keep = _columns(n, pks, msgs, sigs)
    if any(len(lo) and int((hi - lo).max()) >= 1 << 32 for _, lo, hi in name_keep + keep):
        raise ValueError("a cache key field is 2^32 bytes or longer")
    keys = np.empty((n, 32), dtype=np.uint8)
    rep = np.empty(n, dtype=np.int32)
    hits = lib.tmtpu_cache_resolve(None if store is None else store._h, n, *name_ptrs,
                                   None if kind is None else kind.ctypes.data, *ptrs,
                                   keys.ctypes.data, rep.ctypes.data, _threads(nthreads))
    if hits < 0:
        raise MemoryError("the signature cache's resolve is out of memory")
    return keys, rep


def walk_verify(body):
    """The C walk of a VerifyRequest frame body (type byte 3 + payload, any
    contiguous bytes-like):
    [B + 1, 7] int64, row i lane i's pub_key, msg and sig as [lo, hi)
    offsets into ``body`` and its power, row B (as uint64) the request_id,
    curve's [lo, hi), tally, deadline_ms and trace_ctx's [lo, hi); or None
    where the frame holds what only the Python walk takes (a cut field, an
    unsupported wire type, a varint over 64 bits, an earlier non-ASCII
    curve)."""
    lib = load()
    buf = np.frombuffer(body, dtype=np.uint8)
    ptr = buf.ctypes.data
    n = lib.tmtpu_walk_verify(ptr, len(buf), 0, None)
    if n < 0:
        return None
    out = np.empty((n + 1, 7), dtype=np.int64)
    return out if lib.tmtpu_walk_verify(ptr, len(buf), n, out.ctypes.data) == n else None


def sha256_ni(allow=None) -> bool:
    """Whether the cache keys hash with the CPU's SHA extensions (chosen
    when the library loads, where the CPU has them); ``allow`` False
    switches to the portable C, True back. The keys' bytes are the same."""
    return bool(load().tmtpu_sha256_ni(-1 if allow is None else int(bool(allow))))


def cache_keys(types, pks, msgs, sigs, nthreads=None) -> np.ndarray:
    """``sigcache.cache_key`` of every lane: ``types`` the curve names (a
    str a lane, or one str for all), ``pks``, ``msgs``, ``sigs`` columns or
    byte strings. Returns [B, 32] uint8, one key a row."""
    return resolve(None, types, pks, msgs, sigs, nthreads)[0]


def _key_rows(keys) -> np.ndarray:
    """32-byte keys (a list of bytes, or [B, 32] uint8) as C-contiguous rows."""
    if isinstance(keys, np.ndarray):
        rows = np.ascontiguousarray(keys, dtype=np.uint8)
    else:
        rows = np.frombuffer(b"".join(keys), dtype=np.uint8) if keys else np.zeros(0, np.uint8)
    rows = rows.reshape(-1, 32) if rows.size else np.zeros((0, 32), np.uint8)
    if rows.shape[0] != len(keys):
        raise ValueError("cache keys are 32 bytes each")
    return rows


class Store:
    """The C signature-cache store: ``shards`` (a power of two) LRU sets of
    at most ``cap`` 32-byte keys each, the key's first byte picking the
    shard, each shard behind its own mutex. Freed with the object."""

    def __init__(self, shards: int, cap: int):
        if shards < 1 or shards & (shards - 1) or not 1 <= cap < 1 << 30:
            raise ValueError(f"bad store shape: {shards} shards of {cap}")
        self._lib = load()
        self._h = self._lib.tmtpu_cache_new(shards, cap)
        if not self._h:
            raise MemoryError("cannot allocate the signature cache")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.tmtpu_cache_free(self._h)
            self._h = None

    def lookup(self, keys) -> np.ndarray:
        """bool [B]: which keys are present; each hit refreshes its key."""
        rows = _key_rows(keys)
        hit = np.empty(len(rows), dtype=np.uint8)
        self._lib.tmtpu_cache_lookup(self._h, len(rows), rows.ctypes.data, hit.ctypes.data)
        return hit.astype(bool)

    def add(self, keys):
        """Insert the keys in order, refreshing those already there: (new
        keys, evicted keys)."""
        rows = _key_rows(keys)
        evicted = ctypes.c_int64(0)
        inserted = self._lib.tmtpu_cache_add(self._h, len(rows), rows.ctypes.data,
                                             ctypes.byref(evicted))
        if inserted < 0:
            raise MemoryError("the signature cache is out of memory")
        return inserted, evicted.value

    def resize(self, cap: int) -> int:
        """A new cap a shard; returns the keys evicted."""
        if not 1 <= cap < 1 << 30:
            raise ValueError(f"bad shard cap {cap}")
        evicted = self._lib.tmtpu_cache_resize(self._h, cap)
        if evicted < 0:
            raise MemoryError("the signature cache is out of memory")
        return evicted

    def clear(self) -> None:
        self._lib.tmtpu_cache_clear(self._h)

    def size(self) -> int:
        return self._lib.tmtpu_cache_size(self._h)
