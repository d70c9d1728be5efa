"""Verify + voting-power tally on one device, and the vote bitarray pack:
the single-device half of tmtpu/tpu/sharding.py.

The reference carries powers as 5 x 13-bit int32 limbs because the TPU has
no 64-bit integers, and sums Python ints on the host; either way the tally
is exact however large it grows. Here powers go to the device as int64
limbs of 32 bits (``power_limbs``: unsigned limbs under a signed top one,
as many as the largest power needs, at least two), each limb row is summed
in int64 (exact below 2^31 lanes) and the host combines the sums into a
Python int (``readback``), so a tally past 2^63, or a single power past
it, comes out as the reference's. Lanes the host rejected get a false mask bit, so they reach neither the
tally nor the bitarray. The bitarray is packed once per batch, over every
curve's lanes, by ``crypto.batch`` with ``pack_bitarray``. The kernel takes any width, so the device sees
exactly the batch's lanes: there are no pad lanes.
"""

from __future__ import annotations

import numpy as np
import torch

from tmtpu_torch import device as device_mod
from tmtpu_torch.gpu import kernel
from tmtpu_torch.gpu import verify as tv


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
    verdicts), one kernel launch, the tally, one readback."""
    dev = device_mod.resolve(device)
    if len(sigs) == 0:
        return np.zeros(0, dtype=bool), 0
    packed, host_ok = tv.prepare_batch_packed(pks, msgs, sigs)
    return readback(*verify_tally_step_kernel(*upload(packed, powers, host_ok, dev)))
