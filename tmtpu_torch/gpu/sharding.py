"""Verify + voting-power tally on one device or split across several, and
the vote bitarray pack: the port of tmtpu/tpu/sharding.py.

The reference carries powers as 5 x 13-bit int32 limbs because the TPU has
no 64-bit integers, and sums Python ints on the host; either way the tally
is exact however large it grows. Here powers go to the device as int64
limbs of 32 bits (``power_limbs``: unsigned limbs under a signed top one,
as many as the largest power needs, at least two), each limb row is summed
in int64 (exact below 2^31 lanes) and the host combines the sums into a
Python int (``readback``), so a tally past 2^63, or a single power past
it, comes out as the reference's. Lanes the host rejected get a false
mask bit, so they reach neither the tally nor the bitarray. The bitarray
is packed once per batch, over every curve's lanes, when ``crypto.batch``'s
``bit_words`` is first read (``pack_words``). The kernel takes any width,
so the device sees exactly the batch's lanes: there are no pad lanes.

The sharded half (``make_mesh``, ``sharded_verify_tally``,
``sharded_verify_sr``, ``sharded_verify_k1``) is the counterpart of the
reference's pjit / shard_map steps over a ``("sig",)`` mesh. It is not on
the verify path, which uses one device (``crypto/batch.py``, the sidecar
daemon): ``entry.dryrun_multichip`` certifies it and ``bench_torch.py
--flood`` measures it. A caller runs the host prep
(``verify.prepare_batch_packed``) and then the step it needs. One process
drives every shard, as the reference's one controller drives every chip.
A mesh is a tuple of devices, which may repeat one card; lanes go to
contiguous shards of ``ceil(B / 32n) * 32`` lanes (``shard_bounds``: whole
bitarray words, the last shard shorter, empty shards skipped, no pad
lanes). Each shard copies its columns from pinned memory and launches its
kernel on a stream of its own on its device; the join makes ``mesh[0]``'s
stream wait on every shard's event, concatenates the masks there and adds
the limb sums there, where the reference psums them over the mesh, so the
host reads back one set of sums. CPU shards run one after another through
the plain versions, the counterpart of the reference's virtual CPU mesh.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tmtpu_torch import device as device_mod
from tmtpu_torch.gpu import k1_kernel, kernel, spans
from tmtpu_torch.gpu import verify as tv
from tmtpu_torch.libs import metrics, trace


def pack_bitarray(mask: torch.Tensor) -> torch.Tensor:
    """bool [B] -> [ceil(B/32)] words, LSB-first, zero-padded high bits
    (the layout of the reference's uint32 words; held as int64 because
    torch's uint32 lacks the shift and sum kernels)."""
    b = mask.shape[0]
    if b % 32:
        mask = torch.cat([mask, mask.new_zeros(32 - b % 32)])
    w = mask.reshape(-1, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    return (w << shifts[None, :]).sum(dim=1)


def pack_words(mask, device) -> np.ndarray:
    """A host bool mask -> its bitarray words packed on ``device``, read
    back as uint32."""
    words = pack_bitarray(torch.as_tensor(np.asarray(mask, dtype=bool), device=device))
    return words.cpu().numpy().astype(np.uint32)


LIMB_BITS = 32
_LIMB_MASK = (1 << LIMB_BITS) - 1


def power_limbs(powers) -> np.ndarray:
    """Voting powers (ints of any size and sign) -> [L, B] int64 limbs with
    power = sum_k limb_k << 32k: limbs 0..L-2 unsigned 32-bit, the top one
    signed and under 2^31 in magnitude. L is 2 when every power fits int64,
    else the fewest that hold the largest."""
    n = len(powers)
    try:
        p = np.fromiter(powers, dtype=np.int64, count=n)
        n_limbs = 2
    except OverflowError:
        p = np.array([int(v) for v in powers], dtype=object)
        n_limbs = max(int(v).bit_length() for v in powers) // LIMB_BITS + 1
    rows = [(p >> (LIMB_BITS * k)) & _LIMB_MASK for k in range(n_limbs - 1)]
    rows.append(p >> (LIMB_BITS * (n_limbs - 1)))
    return np.stack(rows).astype(np.int64).reshape(n_limbs, n)


def combine_limbs(sums) -> int:
    """Per-limb sums (in ``power_limbs``' order) -> the exact Python int."""
    return sum(int(s) << (LIMB_BITS * k) for k, s in enumerate(sums))


def tally_lanes(mask, powers, ok):
    """Keep the lanes the host accepted (``ok`` bool [B]) and sum their
    ``powers``, int64 [B] or limbs [L, B], over the lanes. Returns (mask
    bool [B], the sums: an int64 scalar or [L])."""
    mask = mask & ok
    return mask, (powers * mask).sum(dim=-1)


def verify_tally_step_compact(packed, powers, ok, base_table):
    """Plain step: verify every lane of the [128, B] plane and tally."""
    return tally_lanes(tv.verify_core_compact(*tv.split_packed(packed), base_table),
                       powers, ok)


def verify_tally_step_kernel(packed, powers, ok):
    """The same step with verification in the CUDA kernel (for a CUDA
    plane; ``kernel.verify_packed`` takes the plain version for a CPU one).
    The tally stays a plain torch op on the device."""
    return tally_lanes(kernel.verify_packed(packed), powers, ok)


def upload(packed, powers, host_ok, device):
    """The host's plane, power limbs and verdicts on ``device``: the
    flush's one host-to-device copy of each."""
    return (torch.from_numpy(packed).to(device),
            torch.from_numpy(power_limbs(powers)).to(device),
            torch.from_numpy(host_ok).to(device))


def readback(mask, tally):
    """(mask bool [B] ndarray, the tally's sums combined into a Python int)
    on the host."""
    return mask.cpu().numpy(), combine_limbs(tally.reshape(-1).cpu().tolist())


def batch_verify_tally(pks, msgs, sigs, powers, device=None):
    """Host-facing fused entry: bytes -> (mask bool [B] ndarray, summed
    voting power of valid lanes as an exact Python int). Host prep, one
    host-to-device copy of the packed plane (plus the powers and the host
    verdicts), one kernel launch, the tally, one readback; each stage under
    the reference's span, and one ``observe_crypto_batch``."""
    dev = device_mod.resolve(device)
    B = len(sigs)
    if B == 0:
        return np.zeros(0, dtype=bool), 0
    impl = metrics.impl_label(dev)
    t0 = time.perf_counter()
    with trace.span("crypto.batch_verify_tally", curve="ed25519", lanes=B) as sp:
        with trace.span("ed25519.prepare", lanes=B):
            packed, host_ok = tv.prepare_batch_packed(pks, msgs, sigs)
        sp.set(impl=impl)
        # no ed25519.pad: no lane is padded, and the power limbs, the rest
        # of the reference's pad stage, are built inside upload
        with trace.span("ed25519.device_put"):
            args = upload(packed, powers, host_ok, dev)
        with trace.span("ed25519.execute", impl=impl) as ex, spans.device_time(ex, dev):
            out = verify_tally_step_kernel(*args)
        with trace.span("ed25519.readback"):
            result = readback(*out)
    metrics.observe_crypto_batch("ed25519", metrics.backend_label(dev), impl, B, 0,
                                 time.perf_counter() - t0)
    return result


def example_batch(lanes: int, device=None) -> torch.Tensor:
    """A deterministic well-formed packed [128, lanes] plane on ``device``
    (one real signature tiled), for compile checks and benchmarks."""
    from tmtpu_torch.crypto import ed25519_ref as ref

    dev = device_mod.resolve(device)
    seed = bytes(range(32))
    msg = b"tmtpu-example-vote-sign-bytes" * 4
    packed, host_ok = tv.prepare_batch_packed([ref.public_key(seed)], [msg],
                                              [ref.sign(seed, msg)])
    if not host_ok.all():
        raise RuntimeError("the example signature failed the host checks")
    return torch.from_numpy(np.ascontiguousarray(np.tile(packed, (1, lanes)))).to(dev)


def make_mesh(n=None, device=None) -> tuple:
    """The devices a sharded step spans. For CUDA, the first ``n`` visible
    cards (all when None; raises with fewer); for ``device="cpu"``, ``n``
    CPU shards (one when None), run one after another."""
    dev = device_mod.resolve(device)
    if n is not None and n < 1:
        raise ValueError(f"a mesh needs at least one device, got {n}")
    if dev.type == "cpu":
        return (dev,) * (n or 1)
    count = torch.cuda.device_count()
    n = count if n is None else n
    if n > count:
        raise RuntimeError(f"a mesh of {n} cards needs {n} visible cards, have {count}")
    return tuple(torch.device("cuda", i) for i in range(n))


def shard_bounds(b: int, n: int) -> list:
    """[(lo, hi)] of the non-empty shards when ``b`` lanes split over ``n``
    devices: ``ceil(b / 32n) * 32`` lanes each, the last one shorter."""
    if b == 0:
        return []
    size = -(-b // (32 * n)) * 32
    return [(lo, min(lo + size, b)) for lo in range(0, b, size)]


def _mesh_devices(mesh) -> tuple:
    mesh = tuple(device_mod.resolve(d) for d in mesh)
    # "cuda" alone names the current card: pin it, so streams, tables and
    # the join all see one index
    mesh = tuple(torch.device("cuda", torch.cuda.current_device())
                 if d.type == "cuda" and d.index is None else d for d in mesh)
    if not mesh:
        raise ValueError("empty mesh")
    if len({d.type for d in mesh}) != 1:
        raise ValueError(f"a mesh holds one device type, got {mesh}")
    return mesh


def _split(mesh: tuple, step, planes) -> list:
    """Run ``step`` over each non-empty shard of the host ``planes``
    (numpy, lanes on the last axis) on its own device, and join. Returns
    each shard's outputs, ready for use on their device's current stream
    and on ``mesh[0]``'s."""
    bounds = shard_bounds(planes[0].shape[-1], len(mesh))
    if mesh[0].type == "cpu":
        return [step(*(torch.from_numpy(np.ascontiguousarray(p[..., lo:hi])) for p in planes))
                for lo, hi in bounds]
    shards = []
    for (lo, hi), dev in zip(bounds, mesh):
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            # a fresh pinned buffer per shard: the caching host allocator
            # keeps it until the copy on this stream has finished
            cols = [torch.from_numpy(np.ascontiguousarray(p[..., lo:hi])).pin_memory()
                    .to(dev, non_blocking=True) for p in planes]
            outs = step(*cols)
            done = stream.record_event()
        shards.append((dev, outs, done))
    root = torch.cuda.current_stream(mesh[0])
    for dev, outs, done in shards:
        root.wait_event(done)
        current = torch.cuda.current_stream(dev)
        if current != root:
            current.wait_event(done)
        for t in outs:
            t.record_stream(current)
    return [outs for _, outs, _ in shards]


def _join_sums(mesh: tuple, sums: list) -> torch.Tensor:
    """The shards' limb sums added on ``mesh[0]`` (a peer copy from another
    card, then one sum)."""
    return torch.stack([s.to(mesh[0], non_blocking=True) for s in sums]).sum(dim=0)


def _join_masks(mesh: tuple, masks: list) -> torch.Tensor:
    return torch.cat([m.to(mesh[0], non_blocking=True) for m in masks])


def _sharded_tally(mesh, step):
    mesh = _mesh_devices(mesh)

    def run(packed: np.ndarray, limbs: np.ndarray, host_ok: np.ndarray):
        """(packed [128, B] uint8, power limbs [L, B] int64, host_ok bool
        [B]) on the host -> (mask bool [B], limb sums [L]) on mesh[0]."""
        if packed.shape[1] == 0:
            return (torch.zeros(0, dtype=torch.bool, device=mesh[0]),
                    torch.zeros(limbs.shape[0], dtype=torch.int64, device=mesh[0]))
        outs = _split(mesh, step, (packed, limbs, host_ok))
        return (_join_masks(mesh, [m for m, _ in outs]),
                _join_sums(mesh, [s for _, s in outs]))
    return run


def _sharded_mask(mesh, verify):
    mesh = _mesh_devices(mesh)

    def run(packed: np.ndarray) -> torch.Tensor:
        """packed [rows, B] uint8 on the host -> bool [B] on mesh[0] (the
        host checks are the caller's)."""
        if packed.shape[1] == 0:
            return torch.zeros(0, dtype=torch.bool, device=mesh[0])
        outs = _split(mesh, lambda p: (verify(p),), (packed,))
        return _join_masks(mesh, [mask for mask, in outs])
    return run


def sharded_verify_tally(mesh):
    """The fused ed25519 verify + tally split over ``mesh``: the kernel on
    each shard (the plain version on CPU shards), the limb sums added on
    ``mesh[0]``."""
    return _sharded_tally(mesh, verify_tally_step_kernel)


def sharded_verify_tally_compact(mesh):
    """The same split with the plain PyTorch step on every shard."""
    return _sharded_tally(mesh, lambda packed, powers, ok: verify_tally_step_compact(
        packed, powers, ok, tv.base_table(packed.device)))


def sharded_verify_sr(mesh):
    """Lane-sharded sr25519 verify of a packed [128, B] plane."""
    return _sharded_mask(mesh, kernel.sr_verify_packed)


def sharded_verify_k1(mesh):
    """Lane-sharded secp256k1 verify of a packed [168, B] plane."""
    return _sharded_mask(mesh, k1_kernel.verify_packed)


def sharded_verify_ed(mesh):
    """Lane-sharded ed25519 verify (mask only) of a packed [128, B] plane."""
    return _sharded_mask(mesh, kernel.verify_packed)
