"""Distributed pose-graph optimization: the Schur-complement LM over edge
shards.

Port of ``my_lidar_graph_slam_v2_tpu/parallel/distributed.py``.  Edges are
grouped by scan node and the groups dealt round-robin over the shards, so
all edges of one scan node, and with them the Schur fill-in pairs, stay in
one shard.  The LM is the single-device one (``graph/optimizer.py``):
its Schur step (``schur_step``, the JAX module's ``_local_schur_step``)
and its error (the JAX module's ``_local_total_error``) already sum their
per-shard partials, in shard order on the mesh's first device, at the JAX
function's five ``psum`` sites; here they sum on over the ranks of a
``torch.distributed`` process group (:class:`RankSum`).  The small dense
solve runs replicated, on identical sums, so every rank takes the same
step.  Node poses are replicated; only the edges shard.

The five sums travel in three collectives per LM step (the per-scan
diagonal blocks with their right-hand sides, the reduced right-hand side
with the reduced matrix, the back-substitution's cross term) plus one for
each error.  Each shard keeps its edges in the graph's order, so a
one-shard mesh runs exactly the single-device LM.

The JAX module's ``make_distributed_optimize`` (one jitted ``shard_map``
of the LM per padded shape) has no counterpart:
:class:`DistributedPoseGraphOptimizer` pads the graph as the
single-device wrapper does, its padded edges dealt like any others, and
runs the LM (``optimize_core``) eagerly, never as a captured CUDA graph.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..graph.optimizer import EdgeShard, OptimizerConfig, PoseGraphOptimizer
from ..utils.transfer import host_sync

# The JAX optimizer clips every edge's information to this spectral norm
# (its own constant, not ``OptimizerConfig.info_clip``).
INFO_CLIP = 1e5


class RankSum:
    """Collectives over the ranks of an initialized ``torch.distributed``
    process group (``group=None``: the default group), counted in
    ``calls``.  NCCL reduces device tensors in place.  Gloo reduces host
    tensors: a CUDA tensor goes through a pinned host copy and back, one
    host round trip per collective."""

    def __init__(self, group=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("RankSum needs an initialized process group "
                               "(parallel/multihost.py:init_multihost)")
        self._dist = dist
        self.group = group
        self.backend = str(dist.get_backend(group))
        self.world_size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.calls = 0

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if self.backend == "nccl" and not t.is_cuda:
            raise ValueError(f"NCCL reduces CUDA tensors, not {t.device}")
        self.calls += 1
        if self.backend == "gloo" and t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            self._dist.all_reduce(host, op=op, group=self.group)
            return host.to(t.device, non_blocking=True)
        t = t.contiguous()
        self._dist.all_reduce(t, op=op, group=self.group)
        return t

    def sum(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Element-wise sums over the ranks of same-dtype tensors on one
        device, in one collective."""
        flat = self._reduce(torch.cat([t.reshape(-1) for t in tensors]),
                            self._dist.ReduceOp.SUM)
        out, i = [], 0
        for t in tensors:
            out.append(flat[i:i + t.numel()].reshape(t.shape))
            i += t.numel()
        return out

    def sum_numpy(self, a: np.ndarray, device) -> np.ndarray:
        """Element-wise sums of a host array over the ranks: gloo reduces
        it on the host, NCCL on ``device``."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.backend != "nccl":
            return self.sum([t])[0].numpy()
        (t,) = self.sum([t.to(device)])
        with host_sync():
            return t.cpu().numpy()

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, self._dist.ReduceOp.MAX)


def partition_edges(scan_idx: np.ndarray, n_shards: int) -> List[np.ndarray]:
    """Edge indices of each of ``n_shards`` shards: the edges grouped by
    scan node, the groups in scan-node order dealt round-robin over the
    shards (JAX ``distributed.py:171-177``); each shard's edges in the
    graph's order."""
    scan_idx = np.asarray(scan_idx, np.int64)
    _, group = np.unique(scan_idx, return_inverse=True)
    shard_of_edge = group % n_shards
    return [np.flatnonzero(shard_of_edge == d) for d in range(n_shards)]


class DistributedPoseGraphOptimizer(PoseGraphOptimizer):
    """The LM's host wrapper with the edges partitioned over the shards of
    every rank (``len(mesh)`` shards per rank, one per mesh device; this
    rank evaluates its own, a shard without edges contributes zeros).  As
    the JAX class: always the Schur step, the information clipped at 1e5,
    the metric series without ``InitialError``.  ``ranks`` (a
    :class:`RankSum`) sums across processes; without it the mesh's shards
    are the whole job."""

    SERIES = tuple(n for n in PoseGraphOptimizer.SERIES
                   if n != "InitialError")

    def __init__(self, mesh, cfg: OptimizerConfig = OptimizerConfig(), *,
                 ranks: Optional[RankSum] = None):
        self.mesh = tuple(torch.device(d) for d in mesh)
        super().__init__(dataclasses.replace(cfg, solver="schur"),
                         device=self.mesh[0])
        self.info_clip = INFO_CLIP
        self.ranks = ranks
        self.reduce = ranks.sum if ranks is not None else None

    def _shards(self, map_idx, scan_idx, is_loop, rel, info,
                real) -> List[EdgeShard]:
        L = len(self.mesh)
        world, rank = ((self.ranks.world_size, self.ranks.rank)
                       if self.ranks is not None else (1, 0))
        edges = partition_edges(scan_idx, world * L)[rank * L:(rank + 1) * L]
        return [EdgeShard.upload(dev, *(a[e] for a in (
                    map_idx, scan_idx, is_loop, rel, info, real)))
                for dev, e in zip(self.mesh, edges) if len(e)]

    def _replays(self, shards) -> bool:
        """Never: the mesh's LM runs eagerly on every mesh, one device
        included, so that its times per device count (``eval_scaling``)
        compare one mechanism."""
        return False
