"""The port's own copies of the reference's observability libraries
(``tmtpu/libs/``): the span ring (``trace.py``) and the metric registry
(``metrics.py``), each cut to what the device path and the sidecar daemon
record. Nothing here imports torch or anything of the JAX package.
"""
