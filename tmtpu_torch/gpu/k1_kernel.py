"""The secp256k1 verify kernel's wrapper, launch counter and plain version.

Counterpart of tmtpu/tpu/k1_kernel.py: the Pallas kernel
``_k1_verify_kernel`` becomes the hand-written CUDA kernel
``csrc/k1_verify.cu``, built by ``build.py`` and bound through a plain C
function with ctypes. ``verify_packed`` launches it for a CUDA tensor and
takes the plain PyTorch version (``k1_verify.plain_packed``) only for
a CPU tensor; there is no fallback from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from tmtpu_torch.gpu import k1_verify
from tmtpu_torch.gpu.kernel import check_packed, launch

# Launches of the CUDA kernel, counted where it is launched and nowhere else.
LAUNCHES = 0


def words8_of_int(v: int) -> np.ndarray:
    """The kernel's field representation: eight little-endian 32-bit words
    (as int32 bit patterns; the kernel reads them as uint32)."""
    return np.frombuffer(int.to_bytes(v, 32, "little"), dtype=np.int32).copy()


def base_table_words() -> np.ndarray:
    """[16, 3, 8] int32: projective (X, Y, Z) of d*G, d = 0..15 (the
    identity (0, 1, 0) at d = 0, Z = 1 otherwise), in the kernel's words;
    the layout of ``k1_point[16]`` in the kernel."""
    rows = [np.stack([words8_of_int(0), words8_of_int(1), words8_of_int(0)])]
    for x, y in k1_verify.fixed_base_affine():
        rows.append(np.stack([words8_of_int(x), words8_of_int(y), words8_of_int(1)]))
    return np.stack(rows)


_TABLES: dict = {}


def _device_table(device: torch.device) -> torch.Tensor:
    if device not in _TABLES:
        _TABLES[device] = torch.as_tensor(base_table_words(), device=device)
    return _TABLES[device]


def verify_packed(packed: torch.Tensor) -> torch.Tensor:
    """Per-lane secp256k1 verify of a packed [168, B] uint8 plane (pkx |
    u1 | u2 | r | rpn, big-endian, parity in row 160). Returns bool [B] on
    the plane's device: the CUDA kernel for a CUDA tensor, the plain
    PyTorch version for a CPU tensor."""
    global LAUNCHES
    check_packed(packed, k1_verify.PACKED_ROWS)
    if packed.shape[1] == 0:
        return torch.zeros(0, dtype=torch.bool, device=packed.device)
    if packed.device.type == "cpu":
        return k1_verify.plain_packed(packed)
    out = launch("k1_verify", packed, _device_table(packed.device))
    LAUNCHES += 1
    return out != 0
