"""The ed25519 and sr25519 verify kernels' wrappers, launch counters and
plain versions.

Counterpart of tmtpu/tpu/kernel.py: the Pallas kernels ``_verify_kernel``
and ``_sr_verify_kernel`` become the hand-written CUDA kernels
``csrc/ed25519_verify.cu`` and ``csrc/sr25519_verify.cu``, built by
``build.py`` and bound through plain C functions with ctypes.
``verify_packed`` and ``sr_verify_packed`` launch them for a CUDA tensor and
take the plain PyTorch versions (``verify.plain_packed``,
``sr_verify.plain_packed``) only for a CPU tensor; there is no
fallback from one to the other. Both kernels read the same fixed-base table
of B.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tmtpu_torch.crypto import ed25519_ref as ref
from tmtpu_torch.gpu import build, sr_verify, verify

# Launches of each CUDA kernel, counted where it is launched and nowhere else.
LAUNCHES = 0  # ed25519_verify
SR_LAUNCHES = 0  # sr25519_verify

_POS = [0, 26, 51, 77, 102, 128, 153, 179, 204, 230, 255]


def limbs10_of_int(v: int) -> np.ndarray:
    """Canonical radix-2^25.5 limbs (the kernel's field representation)."""
    return np.array([(v >> _POS[i]) & ((1 << (_POS[i + 1] - _POS[i])) - 1)
                     for i in range(10)], dtype=np.int32)


def base_table_limbs() -> np.ndarray:
    """[16, 3, 10] int32: niels form (Y-X, Y+X, 2dT) of d*B, d = 0..15, in
    the kernel's limbs; the layout of ``ge_niels[16]`` in the kernel."""
    d2 = 2 * ref.D % ref.P
    rows = []
    for d in range(16):
        x, y = ref.affine(ref.scalar_mult(d, ref.BASE))
        rows.append(np.stack([limbs10_of_int((y - x) % ref.P),
                              limbs10_of_int((y + x) % ref.P),
                              limbs10_of_int(x * y % ref.P * d2 % ref.P)]))
    return np.stack(rows)


_TABLES: dict = {}


def _device_table(device: torch.device) -> torch.Tensor:
    if device not in _TABLES:
        _TABLES[device] = torch.as_tensor(base_table_limbs(), device=device)
    return _TABLES[device]


def check_packed(packed: torch.Tensor, rows: int) -> None:
    """Raise unless ``packed`` is a contiguous [rows, B] uint8 plane on the
    CPU or a CUDA card."""
    if packed.dtype != torch.uint8:
        raise TypeError(f"packed plane must be uint8, got {packed.dtype}")
    if packed.dim() != 2 or packed.shape[0] != rows:
        raise ValueError(f"packed plane must be [{rows}, B], got {tuple(packed.shape)}")
    if not packed.is_contiguous():
        raise ValueError("packed plane must be contiguous")
    if packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {packed.device}")


def launch(name: str, packed: torch.Tensor, table: torch.Tensor,
           lib: ctypes.CDLL = None) -> torch.Tensor:
    """Launch ``csrc/<name>.cu`` (or the same entry of another build,
    ``lib``) over a checked CUDA plane with its table on the current
    stream, through ``<name>_launch(packed, B, table, out, stream)``; B > 0.
    Returns the int32 [B] verdicts; raises if the launch was refused."""
    B = packed.shape[1]
    out = torch.empty(B, dtype=torch.int32, device=packed.device)
    fn = getattr(build.load(name) if lib is None else lib, f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        rc = fn(packed.data_ptr(), B, table.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    return out


def verify_packed(packed: torch.Tensor) -> torch.Tensor:
    """Per-lane ed25519 verify of a packed [128, B] uint8 plane (pk | r |
    s | h). Returns bool [B] on the plane's device: the CUDA kernel for a
    CUDA tensor, the plain PyTorch version for a CPU tensor."""
    global LAUNCHES
    check_packed(packed, 128)
    if packed.shape[1] == 0:
        return torch.zeros(0, dtype=torch.bool, device=packed.device)
    if packed.device.type == "cpu":
        return verify.plain_packed(packed)
    out = launch("ed25519_verify", packed, _device_table(packed.device))
    LAUNCHES += 1
    return out != 0


def sr_verify_packed(packed: torch.Tensor) -> torch.Tensor:
    """Per-lane sr25519 verify of a packed [128, B] uint8 plane (pk | r |
    s | k). Returns bool [B] on the plane's device: the CUDA kernel for a
    CUDA tensor, the plain PyTorch version for a CPU tensor."""
    global SR_LAUNCHES
    check_packed(packed, 128)
    if packed.shape[1] == 0:
        return torch.zeros(0, dtype=torch.bool, device=packed.device)
    if packed.device.type == "cpu":
        return sr_verify.plain_packed(packed)
    out = launch("sr25519_verify", packed, _device_table(packed.device))
    SR_LAUNCHES += 1
    return out != 0
