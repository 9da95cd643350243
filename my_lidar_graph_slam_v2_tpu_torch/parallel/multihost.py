"""Multi-process distributed SLAM on ``torch.distributed``.

Port of ``my_lidar_graph_slam_v2_tpu/parallel/multihost.py``, which
generalizes the reference's two FPGA cores with a halved candidate list
(``loop_detector_fpga_parallel.cpp:32-68``) to N devices across P
processes:

* **Replicated control state, owner-sharded heavy state.**  Every process
  runs the same deterministic host pipeline (pose graph, builder,
  frontend), so no host state is synchronized; the only cross-process
  traffic is the LM's sums and one exchange of loop results per step.
  Every rank must therefore take the same host decisions: values are
  reduced first and decided on after, and every f64 sum runs over shards
  and ranks in a fixed order.
* **Local-map ownership.**  Local map ``m`` belongs to rank ``m % P``.
  Each rank runs only the loop candidates whose map it owns, as one batch
  on its mesh (``parallel/loop_sharded.py``; a rank that owns none
  launches nothing but joins the exchange), and only the owner asks the
  map cache for a raster.
* **Owner retention.**  :func:`apply_owner_retention` drops the rasters
  and scan buffers of finished, aged-out maps on every rank but the
  owner, so per-process memory scales ~T/P.  The owner re-runs an
  uncertified candidate densely and runs the final refinement; the
  ``[Q, 14]`` f64 rows of (pose, covariance, found, score) are exchanged
  with one ``all_reduce`` SUM, exact because each row has one writer.
* **Distributed Schur LM** (``parallel/distributed.py``): each rank
  evaluates its own edge shards; the reduced system is summed over ranks.

The JAX package lays a step's candidates out in owner-major slots and
returns its results in that order; here they come back in query order, as
the one-process detectors return them.  The caller picks the
collectives' backend: NCCL (CUDA tensors, one process per GPU) or gloo
(host tensors; a CUDA tensor is staged through pinned host memory).

Two names of the JAX module have no counterpart of their own: a process
addresses only its own devices, so its mesh is ``parallel/mesh.py``'s
``make_mesh`` (JAX's ``global_mesh``), and a rank's share of the routed
detection is the batched core of ``parallel/loop_sharded.py`` over the
candidates it owns (JAX's ``make_routed_loop_csm``, which all-gathers
every candidate's raw results; here each owner refines its own and
:class:`MultiHostLoopDetector` exchanges the refined rows).
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..core import pose as P2
from ..grid import values as gv
from ..matching.correlative import CorrelativeConfig
from ..matching.types import MapRaster, ScanMatchingQuery
from ..ops import rasterize
from .distributed import RankSum
from .loop_sharded import LoopDetectorShardedCorrelative
from .mesh import make_mesh

BACKENDS = ("nccl", "gloo")


def init_multihost(init_method: str, world_size: int, rank: int, *,
                   backend: str) -> None:
    """Join the process group (``torch.distributed.init_process_group``),
    e.g. ``init_method="tcp://localhost:29500"``.  ``backend`` is "nccl"
    (CUDA only) or "gloo"; the caller chooses, nothing switches it."""
    import torch.distributed as dist

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the NCCL backend needs CUDA; pass backend='gloo' "
                           "for a CPU run")
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def owner_of(local_map_id: int, num_processes: int) -> int:
    """Owning rank of a local map (id-range sharding by modulo)."""
    return int(local_map_id) % num_processes


def _world():
    """(world size, rank) of the default process group; (1, 0) without
    one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def apply_owner_retention(pose_graph, builder, *,
                          num_processes: Optional[int] = None,
                          process_id: Optional[int] = None,
                          keep_last_maps: int = 2) -> dict:
    """Drop non-owned heavy state: for every finished local map older than
    the last ``keep_last_maps`` maps whose owner is another rank, release
    its rasters and the scan buffers of its scan nodes; poses, edges, ids
    and extents stay everywhere.  The scans that the latest-map window or
    a new map's seeding may still read (the last
    ``num_scans_for_latest_map + num_overlapped_scans``) are never dropped
    (``grid_map_builder.cpp:252-276,497-532``).  Idempotent; call after
    each processed scan.  Returns the cumulative holdings."""
    world, rank = _world()
    Pn = num_processes if num_processes is not None else world
    pid = process_id if process_id is not None else rank
    dropped_rasters = dropped_scans = 0
    if Pn > 1 and builder.local_maps:
        cutoff_map = len(builder.local_maps) - keep_last_maps
        n_nodes = len(pose_graph.scan_nodes)
        keep_from = min(
            builder.latest_scan_id_min,
            n_nodes - builder.cfg.num_scans_for_latest_map
            - builder.cfg.num_overlapped_scans,
        )
        for lm in builder.local_maps[:cutoff_map]:
            if not lm.finished or owner_of(lm.local_map_id, Pn) == pid:
                continue
            if lm.holds_raster:
                lm.drop_heavy()
                dropped_rasters += 1
            for nid in range(lm.scan_node_id_min,
                             min(lm.scan_node_id_max + 1, keep_from)):
                if pose_graph.scan_nodes[nid].scan_data is not None:
                    pose_graph.scan_nodes[nid].scan_data = None
                    dropped_scans += 1
    return dict(
        dropped_rasters=dropped_rasters,
        dropped_scans=dropped_scans,
        rasters_held=sum(1 for lm in builder.local_maps if lm.holds_raster),
        scan_buffers_held=sum(
            1 for n in pose_graph.scan_nodes if n.scan_data is not None),
    )


def construct_global_map_sharded(slam, *, margin_cells: int = 8,
                                 ranks: Optional[RankSum] = None):
    """The global map under owner-sharded scan retention: each rank
    integrates the scans it holds into a log-odds raster on an extent
    derived from the (replicated) scan-node poses; one ``all_reduce`` SUM
    of the partials, clipped to the log-odds limits, and one MAX of the u8
    observed masks give the map (log-odds add under per-scan
    independence, ``ConstructGlobalMap``, grid_map_builder.cpp:161-185).
    ``ranks`` defaults to the default process group when one is
    initialized.  Returns (map_pose, MapRaster)."""
    pg, builder = slam.pose_graph, slam.builder
    cfg = builder.cfg
    nodes = pg.scan_nodes
    map_pose = nodes[0].global_pose
    local_xy = np.stack([P2.inverse_compound(map_pose, p)[:2]
                         for p in pg.scan_poses()])
    reach = cfg.usable_range_max + margin_cells * cfg.resolution
    lo_xy = local_xy.min(0) - reach
    hi_xy = local_xy.max(0) + reach
    cols = int(math.ceil((hi_xy[0] - lo_xy[0]) / cfg.resolution / 128.0)) * 128
    rows = int(math.ceil((hi_xy[1] - lo_xy[1]) / cfg.resolution / 128.0)) * 128
    entries = [(nd.global_pose, nd.scan_data) for nd in nodes
               if nd.scan_data is not None]
    dev = builder.device
    lo = torch.zeros((rows, cols), dtype=torch.float32, device=dev)
    obs = torch.zeros((rows, cols), dtype=torch.bool, device=dev)
    if entries:
        lo, obs = builder._integrate(lo, obs, lo_xy, map_pose, entries)
    if ranks is None and _world()[0] > 1:
        ranks = RankSum()
    if ranks is not None:
        # Each scan was integrated by one rank, so the partials sum to the
        # global map (exact up to clip saturation ordering in heavily
        # observed cells, where both orders saturate alike).
        (lo,) = ranks.sum([lo])
        lo = torch.clamp(lo, gv.LOGODDS_MIN, gv.LOGODDS_MAX)
        obs = ranks.max(obs.to(torch.uint8)).to(torch.bool)
    return map_pose, MapRaster(rasterize.prob_map(lo, obs), obs,
                               cfg.resolution, np.asarray(lo_xy, np.float64))


class MultiHostLoopDetector:
    """Loop detector with owner-routed candidates across ranks: the
    result contract of ``LoopDetectorCorrelative``; each rank matches,
    re-runs and refines only the candidates whose map it owns, and one
    ``all_reduce`` gives every rank all results.

    ``rasterized_map_ids`` lists the maps this rank asked the map cache
    for."""

    def __init__(self, cfg, scan_matcher_cfg: CorrelativeConfig,
                 final_scan_matcher, mesh, resolution: float = 0.05,
                 map_cache=None, *, ranks: RankSum):
        self.final = final_scan_matcher
        self.mesh = make_mesh(mesh)
        self.batch = LoopDetectorShardedCorrelative(
            cfg, scan_matcher_cfg, final_scan_matcher, self.mesh,
            resolution=resolution, map_cache=map_cache)
        self.ranks = ranks
        self.num_processes = ranks.world_size
        self.process_id = ranks.rank
        self.rasterized_map_ids: set = set()

    @property
    def map_cache(self):
        return self.batch.map_cache

    def detect(self, queries) -> List[dict]:
        if not queries:
            return []
        owned = [i for i, q in enumerate(queries)
                 if owner_of(q["local_map"].local_map_id,
                             self.num_processes) == self.process_id]
        matched = self.batch.match([queries[i] for i in owned])
        self.rasterized_map_ids.update(
            queries[i]["local_map"].local_map_id for i in owned)

        rows = np.zeros((len(queries), 14), np.float64)
        for i, (raster, arrays, pose, score, found) in zip(owned, matched):
            if not found:
                continue
            est_robot = P2.move_backward(pose, arrays.rel_sensor_pose)
            final = self.final.optimize_pose(
                ScanMatchingQuery(raster, arrays, est_robot))
            rows[i, :3] = final.estimated_pose
            rows[i, 3:12] = np.asarray(final.covariance).ravel()
            rows[i, 12] = 1.0
            rows[i, 13] = score
        # One writer per row: the sum over ranks is exact.
        rows = self.ranks.sum_numpy(rows, self.batch.device)

        results = []
        for i, q in enumerate(queries):
            if not rows[i, 12]:
                continue
            results.append(dict(
                relative_pose=rows[i, :3].copy(),
                local_map_id=q["local_map"].local_map_id,
                scan_node_id=q["query_node"].node_id,
                covariance=rows[i, 3:12].reshape(3, 3).copy(),
                score=float(rows[i, 13]),
            ))
        return results


def create_multihost_backend(mesh, *, ranks: Optional[RankSum] = None,
                             **kw):
    """Backend with owner-routed loop detection and the distributed Schur
    LM over the ranks of the default process group (or ``ranks``), each
    rank on its ``mesh``: ``pipeline/factory.py:create_distributed_backend``
    with its keywords and defaults, given the ranks.  The detector and the
    LM share one :class:`RankSum`, whose ``calls`` count the collectives."""
    from ..pipeline.factory import create_distributed_backend

    return create_distributed_backend(
        mesh, ranks=ranks if ranks is not None else RankSum(), **kw)
