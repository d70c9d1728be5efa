"""Device time for the execute stage of a flush's span tree.

The reference's ``<curve>.execute`` span ends at ``jax.block_until_ready``,
so it holds the device's time. A CUDA launch returns at once, and the
readback's ``.cpu()`` is what would wait, so a plain span would read
microseconds for the launch and give the kernel's time to the readback.
``device_time`` records a CUDA event pair on the device's current stream
around the launches of its body, waits on the end event's
``synchronize()`` (the point the readback would wait for anyway, so the
flush gains no wait) and attaches the events' ``elapsed_time`` to the span
as ``device_ms``. There is no device-wide synchronize, and nothing of this
on the CPU, where the plain versions are synchronous, or while tracing is
off. An exception in the body propagates with no event waited on.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from tmtpu_torch.libs import trace


@contextmanager
def device_time(span, device: torch.device):
    """Time the work the body queues on ``device``'s current stream, wait
    for it at the end, and set ``span``'s ``device_ms``."""
    if device.type != "cuda" or not trace.enabled():
        yield
        return
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    yield
    end.record(stream)
    end.synchronize()
    span.set(device_ms=start.elapsed_time(end))
