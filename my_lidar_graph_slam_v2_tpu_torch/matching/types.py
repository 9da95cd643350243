# The port's own copy of my_lidar_graph_slam_v2_tpu/matching/types.py, logic
# unchanged: the port imports nothing of the JAX package.
"""Scan matching query/summary structures.

Mirrors ``mapping/scan_matcher.hpp:28-83`` of the reference: a query is a
(grid map, scan, map-local initial pose) triple; a summary reports whether
a pose was found, the normalized cost, the estimated map-local robot pose
and its covariance.

Device-friendly representation: the map is a fixed-shape raster (prob with
0 = unknown + observed mask + geometry scalars), the scan a padded beam
array with a validity mask.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np


@dataclass
class MapRaster:
    """Fixed-shape occupancy raster handle (device arrays)."""

    prob: Any  # [H, W] f32, 0 = unknown
    observed: Any  # [H, W] bool
    resolution: float
    offset_xy: Any  # [2] f32 map-local raster offset
    # Optional cached coarse (sliding-window-max) rasters keyed by window
    coarse: dict = field(default_factory=dict)


@dataclass
class ScanArrays:
    """Padded scan: fixed beam capacity with validity mask."""

    ranges: Any  # [B] f32
    angles: Any  # [B] f32
    mask: Any  # [B] bool
    rel_sensor_pose: np.ndarray  # (3,) robot->sensor offset
    num_valid: int
    # Host-side metadata captured at padding time so metric bookkeeping
    # never has to fetch the device arrays back (each device->host read is
    # a full round trip on remote-attached accelerators).
    max_range: float = 0.0

    @property
    def capacity(self) -> int:
        return int(self.ranges.shape[0])


@dataclass
class ScanMatchingQuery:
    grid_map: MapRaster
    scan: ScanArrays
    initial_pose: np.ndarray  # (3,) map-local robot pose


@dataclass
class ScanMatchingSummary:
    pose_found: bool
    normalized_cost: float
    initial_pose: np.ndarray
    estimated_pose: np.ndarray  # (3,) map-local robot pose
    covariance: np.ndarray  # (3, 3) map-local
    normalized_score: float = 0.0
    known_rate: float = 0.0
