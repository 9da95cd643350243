"""Loop detectors.

Port of ``my_lidar_graph_slam_v2_tpu/loop/detector.py``
(``loop_detector_correlative.cpp``, ``loop_detector_branch_bound.cpp``,
``loop_detector_grid_search.cpp``, ``loop_detector_empty.cpp``): for each candidate, match the query scan
against the finished reference local map over a wide window with score
and known-rate gates, refine with the final matcher (unless the matcher
is fused and already refined), and emit a loop edge (map-local relative
pose + covariance).  Map rasters come from the u8 device cache
(``grid/map_cache.py``), whose entries also hold the matchers' pooled
maps.  The detector runs on its scan matcher's device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..core import pose as P
from ..grid.builder import pad_scan
from ..grid.map_cache import DeviceMapCache
from ..matching.types import ScanArrays, ScanMatchingQuery
from ..metrics.registry import MetricManager
from ..utils.transfer import to_device


@dataclass(frozen=True)
class LoopDetectorConfig:
    """Field for field the JAX package's ``LoopDetectorConfig``."""

    score_threshold: float = 0.55
    known_rate_threshold: float = 0.6
    beam_capacity: int = 512
    usable_range_min: float = 0.01
    usable_range_max: float = 20.0


def scan_arrays_batch(scans, capacity: int, device):
    """Padded matching arrays of ``scans`` (all, possibly subsampled,
    beams valid), uploaded once: the ``[N, B]`` device tensors (ranges,
    angles, mask) and one ScanArrays per scan whose beams are their rows."""
    host = []
    for scan in scans:
        r, a, _ = pad_scan(scan, capacity, 0.0, np.inf)
        n = min(scan.num_scans, capacity)
        m = np.zeros(capacity, bool)
        m[:n] = True
        host.append((r, a, m, n))
    ranges, angles, mask = (
        to_device(np.stack([h[k] for h in host]), device) for k in range(3)
    )
    arrays = [
        ScanArrays(
            ranges[i], angles[i], mask[i],
            rel_sensor_pose=np.asarray(scan.relative_sensor_pose, np.float64),
            num_valid=n,
            max_range=float(r[:n].max()) if n else 0.0,
        )
        for i, (scan, (r, _, _, n)) in enumerate(zip(scans, host))
    ]
    return (ranges, angles, mask), arrays


def scan_to_arrays(scan, capacity: int, device) -> ScanArrays:
    """Padded matching arrays of one scan on ``device``."""
    return scan_arrays_batch([scan], capacity, device)[1][0]


class LoopDetectorEmpty:
    """No-op detector (odometry-only mode), ``loop_detector_empty.cpp``."""

    def detect(self, queries) -> List[dict]:
        return []


class LoopDetectorCorrelative:
    """``LoopDetectorCorrelative::Detect``
    (``loop_detector_correlative.cpp:59-156``)."""

    def __init__(self, cfg: LoopDetectorConfig, scan_matcher,
                 final_scan_matcher, resolution: float = 0.05,
                 map_cache=None, name: str = "LoopDetector.Correlative"):
        self.cfg = cfg
        self.scan_matcher = scan_matcher
        self.final_scan_matcher = final_scan_matcher
        self.device = torch.device(scan_matcher.device)
        self.resolution = resolution
        self.map_cache = map_cache or DeviceMapCache(resolution)
        # Reference series (loop_detector_correlative.cpp:17-35);
        # PrecompMapMemoryUsage reports the cache's resident bytes
        vs = MetricManager.instance().value_sequence
        self._m_setup_time = vs(f"{name}.InputSetupTime")
        self._m_detection_time = vs(f"{name}.LoopDetectionTime")
        self._m_num_queries = vs(f"{name}.NumOfQueries")
        self._m_num_detections = vs(f"{name}.NumOfDetections")
        self._m_precomp_memory = vs(f"{name}.PrecompMapMemoryUsage")
        self._spans = (f"{name}.InputSetupTime", f"{name}.LoopDetectionTime")

    def detect(self, queries) -> List[dict]:
        span = MetricManager.instance().span
        results = []
        for q in queries:
            with span(self._spans[0], self._m_setup_time):
                scan_node = q["query_node"]
                local_map = q["local_map"]
                map_node = q["local_map_node"]
                assert local_map.finished, "loop detection against unfinished map"

                raster = self.map_cache.raster(local_map)
                map_local_pose = P.inverse_compound(
                    map_node.global_pose, scan_node.global_pose
                )
                arrays = scan_to_arrays(scan_node.scan_data,
                                        self.cfg.beam_capacity, self.device)
            # Gate-failed candidates spent detection time too
            with span(self._spans[1], self._m_detection_time):
                summary = self.scan_matcher.optimize_pose(
                    ScanMatchingQuery(raster, arrays, map_local_pose),
                    score_threshold=self.cfg.score_threshold,
                    known_rate_threshold=self.cfg.known_rate_threshold,
                )
                if not summary.pose_found:
                    continue
                if getattr(self.scan_matcher, "fused", False):
                    # CSM + GN refinement already ran in one fused sequence
                    final = summary
                else:
                    final = self.final_scan_matcher.optimize_pose(
                        ScanMatchingQuery(raster, arrays,
                                          summary.estimated_pose)
                    )
            results.append(dict(
                relative_pose=final.estimated_pose,
                local_map_id=local_map.local_map_id,
                scan_node_id=scan_node.node_id,
                covariance=final.covariance,
                score=summary.normalized_score,
            ))
        self._m_num_queries.observe(len(queries))
        self._m_num_detections.observe(len(results))
        self._m_precomp_memory.observe(
            sum(e.nbytes for e in self.map_cache._entries.values())
        )
        return results


class LoopDetectorBranchBound(LoopDetectorCorrelative):
    """``LoopDetectorBranchBound`` (``loop_detector_branch_bound.cpp``):
    the same Detect flow with the branch-and-bound matcher
    (``matching/branch_bound.py``), whose pyramid is cached on the map
    cache's entry."""


class LoopDetectorGridSearch(LoopDetectorCorrelative):
    """``LoopDetectorGridSearch`` (``loop_detector_grid_search.cpp``): the
    same Detect flow with the exhaustive grid-search matcher
    (``matching/grid_search.py``)."""
