"""Grid map builder: local-map lifecycle + latest-map maintenance.

Port of ``my_lidar_graph_slam_v2_tpu/grid/builder.py``
(``grid_map_builder.cpp``): pose-graph updates, local maps that start
every ``travel_dist_threshold`` metres and are compacted to u8 once
finished, and the incremental latest map, whose per-scan delta images
are cached per scan node and re-folded by the fused matcher.

Host bookkeeping (poses, hit points) stays f64 NumPy; every array that
crosses to the device is cast to f32 at that boundary, as JAX does
implicitly with x64 off.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..core import pose as P
from ..graph.pose_graph import (
    CONSTRAINT_ODOMETRY,
    EDGE_INTER,
    EDGE_INTRA,
    LocalMapNode,
    PoseGraph,
    PoseGraphEdge,
    ScanNode,
)
from ..matching.types import MapRaster
from ..metrics.registry import MetricManager
from ..ops import quant, rasterize
from ..sensor.data import ScanData
from ..utils.transfer import host_sync, to_device


@dataclass(frozen=True)
class GridMapBuilderConfig:
    """Field for field the JAX package's ``GridMapBuilderConfig``."""

    resolution: float = 0.05
    local_map_rows: int = 1024
    local_map_cols: int = 1024
    latest_map_rows: int = 1024
    latest_map_cols: int = 1024
    num_scans_for_latest_map: int = 10
    travel_dist_threshold: float = 2.5
    num_overlapped_scans: int = 10
    usable_range_min: float = 0.01
    usable_range_max: float = 20.0
    probability_hit: float = 0.62
    probability_miss: float = 0.46
    beam_capacity: int = 512
    samples_per_beam: int = 768
    latest_map_incremental: bool = True
    latest_map_shift_pad: int = 256
    # How a scan's misses reach the raster (ops/rasterize.py): "matmul",
    # exact counts times the weight inside a crop window, or "scatter",
    # one add per miss sample over the whole raster.
    rasterize_backend: str = "matmul"
    compact_finished_maps: bool = True

    def __post_init__(self):
        if self.rasterize_backend not in rasterize.BACKENDS:
            raise ValueError(
                f"rasterize_backend={self.rasterize_backend!r}: one of "
                f"{rasterize.BACKENDS}"
            )

    @property
    def rasterize_crop(self) -> int:
        """Count window covering one scan's sample bounding box."""
        return int(math.ceil(
            2.0 * self.usable_range_max / self.resolution / 128.0
        )) * 128 + 128

    @property
    def logodds_hit(self) -> float:
        return float(np.log(self.probability_hit / (1 - self.probability_hit)))

    @property
    def logodds_miss(self) -> float:
        return float(np.log(self.probability_miss / (1 - self.probability_miss)))


@dataclass
class LocalMap:
    local_map_id: int
    logodds: object  # [H, W] f32 device tensor (None once compacted)
    observed: object  # [H, W] bool device tensor
    offset_xy: np.ndarray  # (2,) raster offset in the local map frame
    scan_node_id_min: int
    scan_node_id_max: int
    finished: bool = False
    version: int = 0  # bumped on every raster write
    prob_q: object = None  # [H, W] u8 device tensor (compacted form)
    compacted: bool = False
    # Pooled maps of the loop matchers, keyed by window
    coarse_cache: dict = field(default_factory=dict)
    # Raster extent, kept as metadata after drop_heavy(): a process that
    # does not own the map (parallel/multihost.py) holds ids, offset and
    # extent only.
    shape: Optional[tuple] = None
    dropped: bool = False

    def __post_init__(self):
        if self.shape is None and self.observed is not None:
            self.shape = tuple(self.observed.shape)

    @property
    def holds_raster(self) -> bool:
        """True when this process can produce the map's raster (the f32
        build raster or the compacted u8 form)."""
        return self.logodds is not None or self.compacted

    def drop_heavy(self):
        """Release the device rasters and pooled maps, keeping ids, offset
        and extent: the owner-retention policy of
        ``parallel/multihost.py`` leaves a finished map's raster with its
        owning process only."""
        if self.observed is not None and self.shape is None:
            self.shape = tuple(self.observed.shape)
        self.logodds = None
        self.observed = None
        self.prob_q = None
        self.compacted = False
        self.coarse_cache.clear()
        self.dropped = True

    def compact(self):
        """Replace the f32 build raster of a finished map with its u8
        matching form, on the device."""
        if self.compacted or self.logodds is None:
            return
        self.prob_q = quant.quantize_prob(self.logodds, self.observed)
        self.logodds = None
        self.coarse_cache.clear()
        self.compacted = True

    def raster(self, resolution: float) -> MapRaster:
        """The map as a matching raster: the u8 form once compacted, the
        f32 probabilities before."""
        if self.compacted:
            prob = self.prob_q
        elif self.logodds is None:
            raise RuntimeError(
                f"local map {self.local_map_id}'s raster was dropped by the "
                "owner-retention policy (another process owns it); route "
                "the request to its owner")
        else:
            prob = rasterize.prob_map(self.logodds, self.observed)
        return MapRaster(prob, self.observed, resolution, self.offset_xy,
                         coarse=self.coarse_cache)


def pad_scan(scan: ScanData, capacity: int, usable_min: float,
             usable_max: float):
    """Padded (ranges, angles, mask) with the usable-range integration
    filter in the mask; uniform subsample if over capacity."""
    min_range = max(usable_min, scan.min_range)
    max_range = min(usable_max, scan.max_range)
    ranges, angles = scan.ranges, scan.angles
    n = len(ranges)
    if n > capacity:
        idx = np.linspace(0, n - 1, capacity).astype(int)
        ranges, angles = ranges[idx], angles[idx]
        n = capacity
    valid = (ranges > min_range) & (ranges < max_range)
    r = np.zeros(capacity, np.float32)
    a = np.zeros(capacity, np.float32)
    m = np.zeros(capacity, bool)
    r[:n] = ranges
    a[:n] = angles
    m[:n] = valid
    return r, a, m


class GridMapBuilder:
    def __init__(self, cfg: GridMapBuilderConfig, device):
        self.cfg = cfg
        self.device = torch.device(device)
        mm = self.metrics = MetricManager.instance()
        vs = mm.value_sequence
        self._m_pg_update_time = vs("GridMapBuilder.PoseGraphUpdateTime")
        self._m_lm_update_time = vs("GridMapBuilder.LocalMapUpdateTime")
        self._m_latest_update_time = vs("GridMapBuilder.LatestMapUpdateTime")
        self._m_lm_interval_dist = vs("GridMapBuilder.LocalMapIntervalTravelDist")
        self._m_num_local_maps = vs("GridMapBuilder.NumOfLocalMapNodes")
        self._m_num_edges = vs("GridMapBuilder.NumOfEdges")
        self._m_lm_memory = vs("GridMapBuilder.LocalMapMemoryUsage")
        self._m_latest_memory = vs("GridMapBuilder.LatestMapMemoryUsage")
        self._m_pg_memory = vs("GridMapBuilder.PoseGraphMemoryUsage")
        self._m_oob_hits = mm.counter("GridMapBuilder.OutOfExtentHits")
        self.local_maps: List[LocalMap] = []
        self._oob_dev = None  # device-accumulated out-of-extent hit count
        self.accum_travel_dist = 0.0
        self.travel_dist_last_local_map = 0.0
        self.latest_logodds = None
        self.latest_observed = None
        self.latest_offset = None
        self.latest_map_pose = np.zeros(3)
        self.latest_scan_id_min = 0
        self.latest_scan_id_max = 0
        # node_id -> (pose fingerprint, anchor cell (2,) int64, delta [H, W])
        self._latest_cache: dict = {}

    # ------------------------------------------------------------------
    def latest_local_map(self) -> LocalMap:
        return self.local_maps[-1]

    def local_map_at(self, local_map_id: int) -> LocalMap:
        return self.local_maps[local_map_id]

    def after_loop_closure(self, pose_graph: PoseGraph):
        """Recompute the accumulated travel distance from the optimized
        poses (``GridMapBuilder::UpdateAccumTravelDist``,
        grid_map_builder.cpp:535-558).  Local map rasters are not rebuilt."""
        nodes = pose_graph.scan_nodes
        if len(nodes) < 2:
            self.accum_travel_dist = 0.0
            return
        poses = pose_graph.scan_poses()
        self.accum_travel_dist = float(
            np.sum(np.hypot(np.diff(poses[:, 0]), np.diff(poses[:, 1])))
        )

    def append_scan(self, pose_graph: PoseGraph, relative_scan_pose,
                    scan_pose_covariance, scan_data: ScanData) -> bool:
        span = self.metrics.span
        with span("GridMapBuilder.PoseGraphUpdateTime",
                  self._m_pg_update_time):
            inserted = self._update_pose_graph(
                pose_graph, relative_scan_pose, scan_pose_covariance, scan_data
            )
        with span("GridMapBuilder.LocalMapUpdateTime", self._m_lm_update_time):
            self._update_grid_map(pose_graph)
        self._m_num_local_maps.observe(len(pose_graph.local_map_nodes))
        self._m_num_edges.observe(len(pose_graph.edges))
        lm = self.latest_local_map()
        self._m_lm_memory.observe(5 * lm.logodds.shape[0] * lm.logodds.shape[1])
        self._m_pg_memory.observe(
            24 * (len(pose_graph.scan_nodes) + len(pose_graph.local_map_nodes))
            + 112 * len(pose_graph.edges)
        )
        return inserted

    # ------------------------------------------------------------------
    def _new_raster(self, rows, cols):
        lo = torch.zeros((rows, cols), dtype=torch.float32, device=self.device)
        obs = torch.zeros((rows, cols), dtype=torch.bool, device=self.device)
        offset = np.array([
            -self.cfg.resolution * (cols // 2),
            -self.cfg.resolution * (rows // 2),
        ])
        return lo, obs, offset

    def _local_hits(self, map_pose, node_pose, scan):
        """(sensor xy, hit points, usable mask) of one scan in the frame
        of ``map_pose``, f64 on the host."""
        cfg = self.cfg
        g_sensor = P.compound(node_pose, scan.relative_sensor_pose)
        l_sensor = P.inverse_compound(map_pose, g_sensor)
        r, a, m = pad_scan(scan, cfg.beam_capacity, cfg.usable_range_min,
                           cfg.usable_range_max)
        ang = l_sensor[2] + a
        hits = np.stack([l_sensor[0] + r * np.cos(ang),
                         l_sensor[1] + r * np.sin(ang)], -1)
        return l_sensor[:2], hits, m

    def _integrate(self, lo, obs, offset_xy, map_pose, scan_entries):
        """Integrate scans (list of (global_node_pose, scan_data)) into a
        raster anchored at ``map_pose``."""
        cfg = self.cfg
        sensors, hits, masks = zip(*(
            self._local_hits(map_pose, pose, scan) for pose, scan in scan_entries
        ))
        lo, obs, n_oob = rasterize.integrate_scans(
            lo, obs,
            to_device(np.array(sensors), self.device, np.float32),
            to_device(np.array(hits), self.device, np.float32),
            to_device(np.array(masks), self.device),
            cfg.resolution,
            to_device(offset_xy, self.device, np.float32),
            cfg.logodds_hit,
            cfg.logodds_miss,
            num_samples=cfg.samples_per_beam,
            crop=min(cfg.rasterize_crop, min(lo.shape)),
            backend=cfg.rasterize_backend,
        )
        self._oob_dev = n_oob if self._oob_dev is None else self._oob_dev + n_oob
        return lo, obs

    def flush_oob(self):
        """Fetch the device-accumulated out-of-extent hit count into the
        ``GridMapBuilder.OutOfExtentHits`` counter (one transfer)."""
        if self._oob_dev is not None:
            with host_sync():
                v = int(self._oob_dev)
            if v:
                self._m_oob_hits.increment(v)
            self._oob_dev = None

    # ------------------------------------------------------------------
    def _append_local_map(self, pose_graph: PoseGraph, scan_pose,
                          scan_pose_cov, scan_node_id):
        """``GridMapBuilder::AppendLocalMap`` (grid_map_builder.cpp:187-286)."""
        cfg = self.cfg
        if self.local_maps:
            lm = self.latest_local_map()
            lm.finished = True
            pose_graph.local_map_nodes[lm.local_map_id].finished = True
            self._m_lm_interval_dist.observe(self.travel_dist_last_local_map)
            if cfg.compact_finished_maps:
                lm.compact()

        local_map_id = len(self.local_maps)
        local_map_pose = np.asarray(scan_pose, np.float64)

        if self.local_maps:
            old_node = pose_graph.local_map_nodes[-1]
            map_local_scan_pose = P.normalize_pose(
                P.inverse_compound(old_node.global_pose, scan_pose)
            )
            local_cov = P.covariance_world_to_local(
                old_node.global_pose, scan_pose_cov
            )
            pose_graph.edges.append(PoseGraphEdge(
                old_node.local_map_id, scan_node_id, EDGE_INTER,
                CONSTRAINT_ODOMETRY, map_local_scan_pose,
                np.linalg.inv(local_cov),
            ))

        pose_graph.local_map_nodes.append(
            LocalMapNode(local_map_id, local_map_pose.copy())
        )

        lo, obs, offset = self._new_raster(cfg.local_map_rows,
                                           cfg.local_map_cols)
        if self.local_maps:
            # Seed with the most recent scans (grid_map_builder.cpp:252-276)
            last_max = self.latest_local_map().scan_node_id_max
            n_seed = min(len(pose_graph.scan_nodes), cfg.num_overlapped_scans)
            first = max(0, last_max - (n_seed - 1))
            entries = [
                (pose_graph.scan_nodes[i].global_pose,
                 pose_graph.scan_nodes[i].scan_data)
                for i in range(first, last_max + 1)
            ]
            lo, obs = self._integrate(lo, obs, offset, local_map_pose, entries)

        self.local_maps.append(LocalMap(
            local_map_id, lo, obs, offset,
            scan_node_id_min=scan_node_id, scan_node_id_max=scan_node_id,
        ))
        self.travel_dist_last_local_map = 0.0

    def _update_pose_graph(self, pose_graph, relative_scan_pose,
                           scan_pose_cov, scan_data) -> bool:
        """``GridMapBuilder::UpdatePoseGraph`` (grid_map_builder.cpp:289-388)."""
        scan_node_id = len(pose_graph.scan_nodes)
        prev_pose = (pose_graph.scan_nodes[-1].global_pose
                     if pose_graph.scan_nodes else np.zeros(3))
        scan_pose = P.compound(prev_pose, relative_scan_pose)

        d = float(P.distance(relative_scan_pose))
        self.accum_travel_dist += d
        self.travel_dist_last_local_map += d

        inserted = (
            not self.local_maps
            or self.travel_dist_last_local_map >= self.cfg.travel_dist_threshold
            or self.latest_local_map().finished
        )
        if inserted:
            self._append_local_map(pose_graph, scan_pose, scan_pose_cov,
                                   scan_node_id)

        lm = self.latest_local_map()
        lm_node = pose_graph.local_map_nodes[-1]
        map_local_scan_pose = P.normalize_pose(
            P.inverse_compound(lm_node.global_pose, scan_pose)
        )
        pose_graph.scan_nodes.append(ScanNode(
            scan_node_id, lm.local_map_id, map_local_scan_pose,
            np.asarray(scan_pose, np.float64), scan_data,
        ))
        local_cov = P.covariance_world_to_local(lm_node.global_pose,
                                                scan_pose_cov)
        pose_graph.edges.append(PoseGraphEdge(
            lm_node.local_map_id, scan_node_id, EDGE_INTRA,
            CONSTRAINT_ODOMETRY, map_local_scan_pose, np.linalg.inv(local_cov),
        ))
        return inserted

    def _update_grid_map(self, pose_graph: PoseGraph):
        """Integrate the newest scan into the current local map
        (``GridMapBuilder::UpdateGridMap``, grid_map_builder.cpp:390-494)."""
        lm = self.latest_local_map()
        lm_node = pose_graph.local_map_nodes[-1]
        node = pose_graph.scan_nodes[-1]
        lm.logodds, lm.observed = self._integrate(
            lm.logodds, lm.observed, lm.offset_xy, lm_node.global_pose,
            [(node.global_pose, node.scan_data)],
        )
        lm.scan_node_id_max = node.node_id
        lm.version += 1

    # ------------------------------------------------------------------
    def update_latest_map(self, pose_graph: PoseGraph):
        """Rebuild the rolling matching map from the last N scans
        (``GridMapBuilder::UpdateLatestMap``, grid_map_builder.cpp:497-532);
        incremental mode re-folds the cached per-scan deltas."""
        cfg = self.cfg
        nodes = pose_graph.scan_nodes
        n = min(len(nodes), cfg.num_scans_for_latest_map)
        first = len(nodes) - n
        self.latest_scan_id_min = nodes[first].node_id
        self.latest_scan_id_max = nodes[-1].node_id
        try:
            with self.metrics.span("GridMapBuilder.LatestMapUpdateTime",
                                   self._m_latest_update_time):
                if (cfg.latest_map_incremental
                        and self._update_latest_incremental(nodes[first:])):
                    return
                self.latest_map_pose = nodes[first].global_pose.copy()
                lo, obs, offset = self._new_raster(cfg.latest_map_rows,
                                                   cfg.latest_map_cols)
                entries = [(nd.global_pose, nd.scan_data)
                           for nd in nodes[first:]]
                self.latest_logodds, self.latest_observed = self._integrate(
                    lo, obs, offset, self.latest_map_pose, entries
                )
                self.latest_offset = offset
        finally:
            if self.latest_logodds is not None:
                self._m_latest_memory.observe(
                    5 * self.latest_logodds.shape[0]
                    * self.latest_logodds.shape[1]
                )

    def _latest_offset(self):
        res = self.cfg.resolution
        return np.array([-res * (self.cfg.latest_map_cols // 2),
                         -res * (self.cfg.latest_map_rows // 2)])

    def _cached_delta(self, nd):
        """(anchor cell, delta) of a scan node, computed once per pose."""
        res = self.cfg.resolution
        fp = nd.global_pose.tobytes()
        ent = self._latest_cache.get(nd.node_id)
        if ent is None or ent[0] != fp:
            cell_k = np.floor(nd.global_pose[:2] / res).astype(np.int64)
            anchor_k = np.array([cell_k[0] * res, cell_k[1] * res, 0.0])
            delta = self._scan_delta(anchor_k, self._latest_offset(), nd)
            ent = (fp, cell_k, delta)
            self._latest_cache[nd.node_id] = ent
        return ent[1], ent[2]

    def _fold_window_inputs(self, window_nodes):
        """Per-scan cached delta images + integer shifts for the latest-map
        window, without materializing the fold; None when the window spread
        exceeds the shift pad (the caller must rebuild in full)."""
        cfg = self.cfg
        res = cfg.resolution
        anchor_cell = np.floor(
            window_nodes[0].global_pose[:2] / res
        ).astype(np.int64)
        deltas, shifts = [], []
        keep = set()
        for nd in window_nodes:
            keep.add(nd.node_id)
            cell_k, delta = self._cached_delta(nd)
            # latest[r, c] = delta[r - dr, c - dc]
            dr = int(cell_k[1] - anchor_cell[1])
            dc = int(cell_k[0] - anchor_cell[0])
            if (abs(dr) > cfg.latest_map_shift_pad
                    or abs(dc) > cfg.latest_map_shift_pad):
                return None
            deltas.append(delta)
            shifts.append((dr, dc))
        for nid in [k for k in self._latest_cache if k not in keep]:
            del self._latest_cache[nid]

        # Pad to the fixed window size, as the JAX fold does.
        n_cap = cfg.num_scans_for_latest_map
        valid = np.zeros(n_cap, bool)
        valid[: len(deltas)] = True
        while len(deltas) < n_cap:
            deltas.append(deltas[0])
            shifts.append((0, 0))
        return dict(
            deltas=tuple(deltas),
            shifts=np.array(shifts, np.int32),
            valid=valid,
            offset_xy=self._latest_offset(),
            map_pose=np.array([anchor_cell[0] * res, anchor_cell[1] * res,
                               0.0]),
            max_shift=cfg.latest_map_shift_pad,
        )

    def latest_fold_inputs(self, pose_graph: PoseGraph):
        """Latest-map fold inputs for the fused matcher
        (``models/fused_matcher.py:fused_core_deltas``); None when the
        incremental path does not apply.  Like the JAX builder, this
        updates latest_map_pose and the id range but leaves the latest
        raster stale: raster readers go through update_latest_map()."""
        cfg = self.cfg
        if not cfg.latest_map_incremental:
            return None
        nodes = pose_graph.scan_nodes
        if not nodes:
            return None
        with self.metrics.span("GridMapBuilder.LatestMapUpdateTime",
                               self._m_latest_update_time) as sp:
            n = min(len(nodes), cfg.num_scans_for_latest_map)
            fold = self._fold_window_inputs(nodes[len(nodes) - n:])
            if fold is None:
                sp.drop()
                return None
            self.latest_scan_id_min = nodes[len(nodes) - n].node_id
            self.latest_scan_id_max = nodes[-1].node_id
            self.latest_map_pose = fold["map_pose"].copy()
        return fold

    def _update_latest_incremental(self, window_nodes) -> bool:
        fold = self._fold_window_inputs(window_nodes)
        if fold is None:
            return False
        self.latest_logodds, self.latest_observed = (
            rasterize.fold_shifted_deltas(
                fold["deltas"], fold["shifts"], fold["valid"],
                max_shift=fold["max_shift"],
            )
        )
        self.latest_offset = fold["offset_xy"]
        self.latest_map_pose = fold["map_pose"]
        return True

    def _scan_delta(self, map_pose, offset, node):
        """Raw delta image of one scan in an axis-aligned raster anchored
        at ``map_pose`` (theta = 0)."""
        cfg = self.cfg
        sensor, hits, m = self._local_hits(map_pose, node.global_pose,
                                           node.scan_data)
        return rasterize.scan_delta(
            (cfg.latest_map_rows, cfg.latest_map_cols),
            to_device(sensor, self.device, np.float32),
            to_device(hits, self.device, np.float32),
            to_device(m, self.device),
            cfg.resolution,
            to_device(offset, self.device, np.float32),
            cfg.logodds_hit,
            cfg.logodds_miss,
            num_samples=cfg.samples_per_beam,
            crop=min(cfg.rasterize_crop, cfg.latest_map_rows,
                     cfg.latest_map_cols),
            backend=cfg.rasterize_backend,
        )

    def prefill_latest_delta(self, pose_graph: PoseGraph):
        """Compute the newest scan node's latest-map delta right after it
        is appended, so the next keyframe's match finds it cached (on the
        card this is queued work that overlaps the host's next steps)."""
        if self.cfg.latest_map_incremental and pose_graph.scan_nodes:
            self._cached_delta(pose_graph.scan_nodes[-1])

    def latest_raster(self) -> MapRaster:
        """u8-quantized matching raster of the rolling latest map."""
        return MapRaster(
            quant.quantize_prob(self.latest_logodds, self.latest_observed),
            self.latest_observed, self.cfg.resolution, self.latest_offset,
        )

    # ------------------------------------------------------------------
    def construct_map_from_scans(self, map_pose, entries, margin_cells=8):
        """Build a map raster covering all given scans, sized from the
        hit-point bounding box.  Returns a MapRaster (f32 probabilities)."""
        cfg = self.cfg
        pts = []
        for node_pose, scan in entries:
            sensor, hits, m = self._local_hits(map_pose, node_pose, scan)
            pts.append(hits[m])
            pts.append(sensor[None, :])
        allpts = np.concatenate(pts, axis=0)
        lo_xy = allpts.min(0) - margin_cells * cfg.resolution
        hi_xy = allpts.max(0) + margin_cells * cfg.resolution
        cols = int(math.ceil((hi_xy[0] - lo_xy[0]) / cfg.resolution / 128.0)) * 128
        rows = int(math.ceil((hi_xy[1] - lo_xy[1]) / cfg.resolution / 128.0)) * 128
        lo = torch.zeros((rows, cols), dtype=torch.float32, device=self.device)
        obs = torch.zeros((rows, cols), dtype=torch.bool, device=self.device)
        offset = np.asarray(lo_xy, np.float64)
        lo, obs = self._integrate(lo, obs, offset, map_pose, entries)
        return MapRaster(rasterize.prob_map(lo, obs), obs, cfg.resolution,
                         offset)

    def construct_global_map(self, pose_graph: PoseGraph):
        """Global map anchored at the first scan node's pose
        (``ConstructGlobalMap``, grid_map_builder.cpp:161-185)."""
        nodes = pose_graph.scan_nodes
        map_pose = nodes[0].global_pose
        entries = [(nd.global_pose, nd.scan_data) for nd in nodes]
        return map_pose, self.construct_map_from_scans(map_pose, entries)
