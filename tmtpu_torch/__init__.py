"""PyTorch/CUDA port of tmtpu's device layer.

Batched ed25519, sr25519 and secp256k1 signature verification with the
voting-power tally and the vote bitarray, run on an NVIDIA H100 through
hand-written CUDA kernels (``gpu/csrc/``), behind the verify-once
signature cache; and the verification sidecar daemon that serves it to
tmtpu nodes over the sidecar wire protocol (``sidecar/``, ``python -m
tmtpu_torch sidecar``). The JAX package ``tmtpu`` is the reference: this
package imports nothing from it and keeps its own copies of what it needs.
Entry points take ``device``; ``None`` means the CUDA card.
"""
