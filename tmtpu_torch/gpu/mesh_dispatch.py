"""Mesh dispatch: split production verify flushes across every card.

The port of tmtpu/tpu/mesh_dispatch.py. ``crypto.batch.TorchBatchVerifier``
asks ``route`` for each curve of a flush; a flush of at least
``shard_min_lanes`` lanes on a mesh of two or more devices goes through
``batch_verify_tally_mesh`` (ed25519 with the tally: the limb sums added on
the first card, one readback) or ``batch_verify_mesh`` (a mask, any
curve), both over ``gpu/sharding.py``'s split. Either returns the exact
single-device result or raises: there is no breaker and no fallback from
the mesh to one device or to the CPU.

The knobs are the reference's (``[crypto] mesh_devices``, 0 = every
visible card, and ``shard_min_lanes``), set by ``configure`` or
``set_overrides``; ``TMTPU_MESH_DEVICES`` and ``TMTPU_SHARD_MIN_LANES``
override them, read at call time. The port's default differs from the
reference's: ``mesh_devices`` is 1, the mesh is off, and a caller opts in
with 0 or a count. On four H100s the split of a 10,000-lane flush took
longer than one card's flush (PERF.md, "the lane split"): host prep, not
the kernel, bounds a flush, and the split adds copies and a join without
dividing it. On the CPU a mesh is ``mesh_devices()`` shards of the one
CPU, so a test sets ``TMTPU_MESH_DEVICES=4`` as the reference's tests do. The counters
(``dispatch_count``, ``snapshot``) are the sidecar daemon's Stats. Each
shard holds its actual lanes: the reference's pad to 32 x n lanes is gone,
and ``snapshot()["last"]["shard_lanes"]`` lists the shards' sizes.

Each dispatch records the reference's span (``crypto.mesh_verify_tally``
or ``crypto.mesh_verify``, its device time from an event pair on the first
device's stream, which the join makes wait on every shard), the mesh
families (``crypto_mesh_*``; a shard's lanes are the first shard's, the
pad ratio 1; ``crypto_mesh_psum_seconds`` the host readback of the joined
limb sums once the join's event has passed) and one
``observe_crypto_batch`` with ``impl="mesh"``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tmtpu_torch import device as device_mod
from tmtpu_torch.gpu import k1_verify as kv
from tmtpu_torch.gpu import sharding, spans
from tmtpu_torch.gpu import sr_verify as sv
from tmtpu_torch.gpu import verify as tv
from tmtpu_torch.libs import metrics, trace

ED25519 = "ed25519"
SR25519 = "sr25519"
SECP256K1 = "secp256k1"

_lock = threading.Lock()
# the reference's CryptoConfig has mesh_devices 0 (every card); the port
# ships the mesh off (module docstring)
DEFAULTS = {"mesh_devices": 1, "shard_min_lanes": 2048}
_cfg = dict(DEFAULTS)
_state: Dict = {"dispatches": 0, "devices": 0, "occupancy": {}, "last": None}


class MeshUnavailable(RuntimeError):
    """The mesh would have fewer than two devices."""


def configure(crypto_cfg) -> None:
    """Apply a config object's ``mesh_devices`` and ``shard_min_lanes``."""
    set_overrides(**{k: getattr(crypto_cfg, k, v) for k, v in DEFAULTS.items()})


def set_overrides(mesh_devices: Optional[int] = None,
                  shard_min_lanes: Optional[int] = None) -> None:
    """Set the knobs (the sidecar daemon's start); None leaves one as it is."""
    with _lock:
        if mesh_devices is not None:
            _cfg["mesh_devices"] = int(mesh_devices)
        if shard_min_lanes is not None:
            _cfg["shard_min_lanes"] = int(shard_min_lanes)


def reset() -> None:
    """Zero the counters (tests)."""
    with _lock:
        _state.update(dispatches=0, devices=0, occupancy={}, last=None)


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    if raw:
        try:
            return int(raw)
        except ValueError:
            pass
    return default


def mesh_devices() -> int:
    """The configured mesh width; 0 = every visible card, 1 = off."""
    return _env_int("TMTPU_MESH_DEVICES", _cfg["mesh_devices"])


def shard_min_lanes() -> int:
    return _env_int("TMTPU_SHARD_MIN_LANES", _cfg["shard_min_lanes"])


def mesh_for(device=None) -> tuple:
    """The mesh a flush on ``device`` would span now: the first
    ``mesh_devices()`` visible cards (every one for 0), or that many CPU
    shards for the CPU (one for 0)."""
    dev = device_mod.resolve(device)
    want = mesh_devices()
    if dev.type == "cpu":
        return sharding.make_mesh(max(1, want), dev)
    count = torch.cuda.device_count()
    return sharding.make_mesh(count if want <= 0 else min(want, count), dev)


def route(curve: str, lanes: int, device=None) -> bool:
    """Should this flush ride the mesh? False below the lane threshold or
    when the mesh on ``device``'s type would have fewer than two shards."""
    if lanes < max(1, shard_min_lanes()):
        return False
    return len(mesh_for(device)) >= 2


def _mesh(device, mesh) -> tuple:
    mesh = mesh_for(device) if mesh is None else tuple(device_mod.resolve(d) for d in mesh)
    if len(mesh) < 2:
        raise MeshUnavailable(f"a mesh needs two or more devices, have {len(mesh)} "
                              f"(mesh_devices={mesh_devices()})")
    return mesh


def _note_dispatch(curve: str, lanes: int, n: int, backend: str, psum_s: float,
                   seconds: float) -> None:
    """Count one dispatch in the Stats, the mesh families and the crypto
    families (``impl="mesh"``). With no pad lanes, a shard's lanes are the
    first (largest) shard's and the pad ratio is 1."""
    sizes = [hi - lo for lo, hi in sharding.shard_bounds(lanes, n)]
    sizes += [0] * (n - len(sizes))
    with _lock:
        _state["dispatches"] += 1
        _state["devices"] = n
        for d, size in enumerate(sizes):
            _state["occupancy"][d] = _state["occupancy"].get(d, 0) + size
        _state["last"] = {"seq": _state["dispatches"], "curve": curve, "lanes": lanes,
                          "devices": n, "shard_lanes": sizes, "seconds": round(seconds, 6)}
    metrics.crypto_mesh_devices.set(n)
    metrics.crypto_mesh_dispatches_total.inc(curve=curve)
    metrics.crypto_mesh_shard_lanes.observe(sizes[0], curve=curve)
    metrics.crypto_mesh_pad_ratio.observe(1.0, curve=curve)
    metrics.crypto_mesh_psum_seconds.observe(psum_s)
    metrics.observe_crypto_batch(curve, backend, "mesh", lanes, 0, seconds)


def dispatch_count() -> int:
    with _lock:
        return _state["dispatches"]


def snapshot() -> Dict:
    """Mesh occupancy for the sidecar's Stats: each shard's cumulative
    lanes and the last dispatch's shape."""
    with _lock:
        return {
            "devices": _state["devices"],
            "mesh_devices": mesh_devices(),
            "shard_min_lanes": shard_min_lanes(),
            "dispatches": _state["dispatches"],
            "occupancy_lanes": {str(d): v for d, v in sorted(_state["occupancy"].items())},
            "last": dict(_state["last"]) if _state["last"] else None,
        }


def batch_verify_tally_mesh(pks, msgs, sigs, powers, device=None,
                            mesh=None) -> Tuple[np.ndarray, int]:
    """ed25519 verify + tally across the mesh: the exact result of
    ``sharding.batch_verify_tally``. Host prep once for the whole flush,
    the split, one readback. ``mesh`` (a tuple of devices, which may repeat
    one card) replaces the configured mesh. Raises on any failure."""
    b = len(sigs)
    if b == 0:
        return np.zeros(0, dtype=bool), 0
    mesh = _mesh(device, mesh)
    n = len(mesh)
    t0 = time.perf_counter()
    with trace.span("crypto.mesh_verify_tally", curve=ED25519, lanes=b, shards=n) as sp:
        packed, host_ok = tv.prepare_batch_packed(pks, msgs, sigs)
        sp.set(impl=metrics.impl_label(mesh[0]))
        # the join's event on the first device ends the device time: it
        # waits on every shard's stream, with no device-wide sync
        with spans.device_time(sp, mesh[0]):
            mask, sums = sharding.sharded_verify_tally(mesh)(
                packed, sharding.power_limbs(powers), host_ok)
        # the reference's psum readback: the joined limb sums to the host
        t_mask = time.perf_counter()
        tallied = sharding.combine_limbs(sums.cpu().tolist())
        psum_s = time.perf_counter() - t_mask
        mask = mask.cpu().numpy()
    _note_dispatch(ED25519, b, n, metrics.backend_label(mesh[0]), psum_s,
                   time.perf_counter() - t0)
    return mask, tallied


_MASK_PATHS = {
    ED25519: (tv.prepare_batch_packed, sharding.sharded_verify_ed),
    SR25519: (sv.prepare_sr_batch_packed, sharding.sharded_verify_sr),
    SECP256K1: (kv.prepare_k1_batch_packed, sharding.sharded_verify_k1),
}


def batch_verify_mesh(curve: str, pks, msgs, sigs, device=None, mesh=None) -> np.ndarray:
    """Mask-only lane-sharded verify of any supported curve: the exact
    result of ``batch_verify`` / ``batch_verify_sr`` / ``batch_verify_k1``.
    Raises on any failure."""
    if curve not in _MASK_PATHS:
        raise ValueError(f"unsupported mesh curve {curve!r}")
    b = len(sigs)
    if b == 0:
        return np.zeros(0, dtype=bool)
    mesh = _mesh(device, mesh)
    n = len(mesh)
    prep, build = _MASK_PATHS[curve]
    t0 = time.perf_counter()
    with trace.span("crypto.mesh_verify", curve=curve, lanes=b, shards=n) as sp:
        packed, host_ok = prep(pks, msgs, sigs)
        with spans.device_time(sp, mesh[0]):
            mask = build(mesh)(packed)
        mask = mask.cpu().numpy() & host_ok
    _note_dispatch(curve, b, n, metrics.backend_label(mesh[0]), 0.0,
                   time.perf_counter() - t0)
    return mask
