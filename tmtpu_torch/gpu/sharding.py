"""Verify + voting-power tally on one device, and the vote bitarray pack:
the single-device half of tmtpu/tpu/sharding.py.

The reference carries powers as 5 x 13-bit int32 limbs only because the
TPU has no 64-bit integers; here powers are int64 on the device and the
tally is one int64 sum, equal to the reference's ``limb_sums_to_int``.
Lanes the host rejected get a false mask bit, so they reach neither the
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


def verify_tally_step_compact(packed, powers, ok, base_table):
    """Plain step: verify every lane of the [128, B] plane, keep the lanes
    the host accepted (``ok`` bool [B]) and sum their int64 ``powers``.
    Returns (mask bool [B], tally int64 scalar)."""
    mask = tv.verify_core_compact(*tv.split_packed(packed), base_table) & ok
    return mask, (powers * mask).sum()


def verify_tally_step_kernel(packed, powers, ok):
    """The same step with verification in the CUDA kernel (for a CUDA
    plane; ``kernel.verify_packed`` takes the plain version for a CPU one).
    The tally stays a plain torch op on the device."""
    mask = kernel.verify_packed(packed) & ok
    return mask, (powers * mask).sum()


def batch_verify_tally(pks, msgs, sigs, powers, device=None):
    """Host-facing fused entry: bytes -> (mask bool [B] ndarray, summed
    voting power of valid lanes as a Python int). One host-to-device copy of
    the packed plane (plus the powers and the host verdicts), one kernel
    launch, one readback."""
    dev = device_mod.resolve(device)
    B = len(sigs)
    if B == 0:
        return np.zeros(0, dtype=bool), 0
    packed, host_ok = tv.prepare_batch_packed(pks, msgs, sigs)
    mask, tally = verify_tally_step_kernel(
        torch.from_numpy(packed).to(dev),
        torch.as_tensor(np.asarray(powers, dtype=np.int64), device=dev),
        torch.from_numpy(host_ok).to(dev))
    return mask.cpu().numpy(), int(tally.item())
