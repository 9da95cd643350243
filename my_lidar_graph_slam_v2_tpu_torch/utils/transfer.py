"""Host <-> device transfers.

A plain ``torch.as_tensor(numpy_array, device="cuda")`` copies from
pageable memory and synchronizes the stream, so every small upload would
wait for all queued device work.  Here uploads go through pinned memory
asynchronously on the current stream, scalar constants are made on the
device by a fill kernel, and a match's results come back in one fetch.

Every device-to-host transfer of the main path runs inside
:func:`host_sync`: the registry counter ``Device.HostFetches`` counts it
and a ``fetch`` span times it, so the span's time is the host's wait for
the device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..metrics.registry import MetricManager


def to_device(a, device, dtype=None) -> torch.Tensor:
    """A host array (NumPy or anything ``np.asarray`` takes) as a tensor
    on ``device`` with its own storage; ``dtype`` is a NumPy dtype applied
    on the host (e.g. ``np.float32`` for f64 host bookkeeping)."""
    t = torch.from_numpy(np.array(a, dtype=dtype, copy=True, order="C"))
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def f32(x, device) -> torch.Tensor:
    """0-d f32 tensor holding ``x`` on ``device`` (no host copy).

    Dividing by such a tensor keeps the division IEEE on both CPU and
    CUDA; a Python-scalar divisor takes a multiply-by-reciprocal path on
    CUDA, which rounds differently from XLA."""
    return torch.full((), x, dtype=torch.float32, device=device)


def host_sync():
    """The context of one device-to-host transfer: counted in
    ``Device.HostFetches`` and timed as a ``fetch`` span."""
    mm = MetricManager.instance()
    mm.counter("Device.HostFetches").increment()
    return mm.span("fetch")


def fetch(tensors):
    """One device-to-host transfer for a tuple of small tensors: returns
    f64 NumPy arrays of the original shapes.  Every value is exact in f32
    (poses, costs, covariances, counts below 2^24, 0/1 flags)."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    with host_sync():
        host = flat.cpu().numpy().astype(np.float64)
    out, i = [], 0
    for t in tensors:
        k = t.numel()
        out.append(host[i:i + k].reshape(tuple(t.shape)))
        i += k
    return out
