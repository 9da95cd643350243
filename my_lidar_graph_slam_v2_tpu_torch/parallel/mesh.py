"""Device mesh: the devices one process fans its work out over.

Port of ``my_lidar_graph_slam_v2_tpu/parallel/mesh.py``.  The JAX package's
mesh is a ``jax.sharding.Mesh`` with one named axis (``AXIS_CANDIDATES``)
over every chip; loop candidates and pose-graph edges shard over it.  Here
a mesh is an ordered tuple of this process's ``torch.device`` objects:
the batched loop detector splits a step's candidates into one contiguous
chunk per device, and the distributed LM puts one edge shard on each.
Several processes join through a ``torch.distributed`` process group
(``parallel/multihost.py``), each with its own mesh.

Three names of the JAX module have no counterpart: ``AXIS_CANDIDATES`` (a
tuple has no named axes), ``to_global`` (a process uploads its own shards
itself; there is no global array to assemble) and ``pad_to_multiple`` (the
port pads no shard or batch, ROADMAP 3.8).
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch


def make_mesh(devices: Optional[Iterable] = None) -> Tuple[torch.device, ...]:
    """The mesh over ``devices`` (``torch.device`` objects or names such as
    ``"cuda:1"``; a device may repeat, as the CPU tests' eight ``"cpu"``
    shards do), in their order.  With no argument, every local GPU; without
    one that raises, since the entry points never fall back to the CPU."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "make_mesh() takes every local GPU and found none; pass the "
                "devices, e.g. make_mesh(['cpu'])")
        devices = [torch.device("cuda", i) for i in range(n)]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh
